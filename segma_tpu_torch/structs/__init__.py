"""Small data structures (counterpart of ``segma_tpu/structs/``)."""
