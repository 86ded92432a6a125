from .engine import InferenceEngine
