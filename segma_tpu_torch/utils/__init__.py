"""Audio, label and unit helpers (numpy only)."""
