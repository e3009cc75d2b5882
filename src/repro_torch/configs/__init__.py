from .base import ArchConfig, ShapeCell, SHAPES, SHAPES_BY_NAME, applicable_shapes  # noqa: F401
from .registry import ARCHS, get_arch  # noqa: F401
