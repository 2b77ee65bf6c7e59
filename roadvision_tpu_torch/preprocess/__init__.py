from .base import PreprocessOp
from .pipeline import PreprocessPipeline
from .registry import REGISTRY, get_op_class, register

__all__ = ["PreprocessOp", "PreprocessPipeline", "REGISTRY", "get_op_class",
           "register"]
