from .server import GenerationRequest, GenerationResult, InferenceServer, serve_http

__all__ = ["GenerationRequest", "GenerationResult", "InferenceServer", "serve_http"]
