from .pipeline import PreprocessPipeline
from .registry import REGISTRY, get_op_class

__all__ = ["PreprocessPipeline", "REGISTRY", "get_op_class"]
