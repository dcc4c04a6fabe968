from segma_tpu_torch.models.hubert.builders import HUBERT_CONV_SETTINGS, build_hubert_model

__all__ = ["HUBERT_CONV_SETTINGS", "build_hubert_model"]
