from .inference import BatchedInference

__all__ = ["BatchedInference"]
