from segma_tpu_torch.models.wavlm.builders import WAVLM_CONV_SETTINGS, build_wavlm_model

__all__ = ["WAVLM_CONV_SETTINGS", "build_wavlm_model"]
