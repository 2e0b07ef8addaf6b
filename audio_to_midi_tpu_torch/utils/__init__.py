from . import visualize

__all__ = ["visualize"]
