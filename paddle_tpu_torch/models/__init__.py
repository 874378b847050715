"""Models (mirrors ``paddle_tpu.models``)."""
from .gpt import (GPT, GPTConfig, gpt_ragged_apply, gpt_tiny,
                  load_reference_state)

__all__ = ["GPT", "GPTConfig", "gpt_ragged_apply", "gpt_tiny",
           "load_reference_state"]
