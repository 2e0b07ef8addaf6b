from .frontend import slice_full_audio

__all__ = ["slice_full_audio"]
