"""Models (mirrors ``paddle_tpu.models``)."""
from .bert import (Bert, BertBlock, BertConfig, BertForPretraining,
                   bert_tiny)
from .ernie import ErnieConfig, ErnieForPretraining, ernie_tiny
from .gpt import (GPT, GPTConfig, GPTForGeneration, gpt_cached_apply,
                  gpt_paged_suffix_apply, gpt_ragged_apply, gpt_tiny,
                  load_reference_state, state_to_numpy)

__all__ = ["Bert", "BertBlock", "BertConfig", "BertForPretraining",
           "bert_tiny", "ErnieConfig", "ErnieForPretraining", "ernie_tiny",
           "GPT", "GPTConfig", "GPTForGeneration", "gpt_cached_apply",
           "gpt_paged_suffix_apply", "gpt_ragged_apply", "gpt_tiny",
           "load_reference_state", "state_to_numpy"]
