"""Audio annotation record with ``.aa`` and RTTM (de)serialization
(counterpart of ``segma_tpu/annotation.py``). The ``.aa`` line format is
``<uid> <start_time_s> <duration_s> <label>``."""

from __future__ import annotations

from dataclasses import dataclass

from segma_tpu_torch.utils.conversions import second_to_millisecond, seconds_to_frames


@dataclass
class AudioAnnotation:
    """A labeled time segment of one audio file."""

    uid: str
    start_time_s: float
    duration_s: float
    label: str
    PRECISION: int = 8

    @classmethod
    def read_line(cls, line: str) -> "AudioAnnotation":
        """Parse one ``.aa`` line: ``<uid> <start_s> <duration_s> <label>``."""
        uid, start_time, duration, label = line.split()
        return cls(uid, float(start_time), float(duration), label)

    def write(self, n_digits: int = 8) -> str:
        """Serialize to the ``.aa`` space-separated line format."""
        return (
            f"{self.uid} {round(self.start_time_s, n_digits)} "
            f"{round(self.duration_s, n_digits)} {self.label}"
        )

    @property
    def end_time_s(self) -> float:
        return self.start_time_s + self.duration_s

    @property
    def start_time_ms(self) -> float:
        return second_to_millisecond(self.start_time_s)

    @property
    def duration_ms(self) -> float:
        return second_to_millisecond(self.duration_s)

    @property
    def end_time_ms(self) -> float:
        return second_to_millisecond(self.end_time_s)

    @property
    def start_time_f(self) -> int:
        return seconds_to_frames(self.start_time_s)

    @property
    def duration_f(self) -> int:
        return seconds_to_frames(self.duration_s)

    @property
    def end_time_f(self) -> int:
        return seconds_to_frames(self.end_time_s)

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

    def __str__(self) -> str:
        p = self.PRECISION
        return (
            f"{self.uid}: [{round(self.start_time_s, p)} s, "
            f"{round(self.end_time_s, p)} s] "
            f"({round(self.duration_s, p)} s) label={self.label}"
        )

    def __repr__(self) -> str:
        return self.write()
