from .server import GenerationRequest, GenerationResult, InferenceServer

__all__ = ["GenerationRequest", "GenerationResult", "InferenceServer"]
