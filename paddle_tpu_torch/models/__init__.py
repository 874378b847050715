"""Models (mirrors ``paddle_tpu.models``)."""
from .gpt import (GPT, GPTConfig, GPTForGeneration, gpt_cached_apply,
                  gpt_paged_suffix_apply, gpt_ragged_apply, gpt_tiny,
                  load_reference_state, state_to_numpy)

__all__ = ["GPT", "GPTConfig", "GPTForGeneration", "gpt_cached_apply",
           "gpt_paged_suffix_apply", "gpt_ragged_apply", "gpt_tiny",
           "load_reference_state", "state_to_numpy"]
