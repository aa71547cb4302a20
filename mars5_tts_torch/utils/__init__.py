from .device import ints_on_device
from .masks import construct_padding_mask, length_to_mask
from .profiling import StageTimer

__all__ = ["StageTimer", "construct_padding_mask", "ints_on_device", "length_to_mask"]
