"""Inference front ends (mirrors ``paddle_tpu.inference``). This slice has
``ServingPredictor``; the artifact ``Predictor`` comes later."""
from .serving import ServingPredictor

__all__ = ["ServingPredictor"]
