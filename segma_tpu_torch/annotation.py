"""Audio annotation record with RTTM (de)serialization (counterpart of
``segma_tpu/annotation.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AudioAnnotation:
    """A labeled time segment of one audio file."""

    uid: str
    start_time_s: float
    duration_s: float
    label: str
    PRECISION: int = 8

    @property
    def end_time_s(self) -> float:
        return self.start_time_s + self.duration_s

    def to_rttm(self) -> str:
        """Serialize to an RTTM ``SPEAKER`` line."""
        return " ".join(
            [
                "SPEAKER",
                self.uid,
                "<NA>",
                f"{round(self.start_time_s, self.PRECISION)}",
                f"{round(self.duration_s, self.PRECISION)}",
                "<NA> <NA>",
                self.label,
                "<NA> <NA>",
            ]
        )

    @classmethod
    def from_rttm(cls, line: str) -> "AudioAnnotation":
        """Parse one RTTM line (9 or 10 fields; channel field optional)."""
        fields = line.split()
        if len(fields) not in (9, 10):
            raise ValueError(f"malformed RTTM line ({len(fields)} fields): {line!r}")
        return cls(
            uid=fields[1],
            start_time_s=float(fields[3]),
            duration_s=float(fields[4]),
            label=fields[7],
        )
