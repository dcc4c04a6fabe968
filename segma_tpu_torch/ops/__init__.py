"""Operators: the log-mel frontend and attention, each with its CUDA kernel,
and the kernel wrappers' launch counters."""


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches since its counter was last set."""
    from segma_tpu_torch.ops import attention, logmel

    return {"logmel": logmel.launches, "flash_attn_fwd": attention.launches,
            "flash_attn_bwd": attention.bwd_launches,
            "flash_attn_fwd_f32": attention.launches_f32,
            "flash_attn_bwd_f32": attention.bwd_launches_f32}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counters (``launch_counts``'s keys)."""
    from segma_tpu_torch.ops import attention, logmel

    logmel.launches = counts["logmel"]
    attention.launches, attention.bwd_launches = counts["flash_attn_fwd"], counts["flash_attn_bwd"]
    attention.launches_f32 = counts["flash_attn_fwd_f32"]
    attention.bwd_launches_f32 = counts["flash_attn_bwd_f32"]
