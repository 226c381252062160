"""Input-type declarations for automatic layer wiring.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``: the shape
(without the batch) and kind of a network input, from which
``ListBuilder.set_input_type`` infers each layer's ``n_in`` and inserts
the shape preprocessors between layer families. Image tensors are NHWC
and sequences [batch, time, features], as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    """Shape (excluding batch) + kind of a network input."""

    kind: str  # "ff" | "cnn" | "rnn"
    size: Optional[int] = None  # ff: feature count; rnn: features per step
    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None
    timesteps: Optional[int] = None  # rnn: may be None (variable)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=size)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=height, width=width, channels=channels)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=size, timesteps=timesteps)

    def flat_size(self) -> int:
        if self.kind == "ff":
            return int(self.size)
        if self.kind == "cnn":
            return int(self.height * self.width * self.channels)
        if self.kind == "rnn":
            return int(self.size)
        raise ValueError(self.kind)

    def batch_shape(self, batch: int) -> Tuple[int, ...]:
        if self.kind == "ff":
            return (batch, self.size)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "rnn":
            return (batch, self.timesteps or 1, self.size)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
