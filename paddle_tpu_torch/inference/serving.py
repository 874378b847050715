"""ServingPredictor: the continuous-batching engine behind the Predictor
surface (mirrors ``paddle_tpu/inference/serving.py``).

Same calling shape as a Predictor (``run([inputs]) -> [outputs]``,
``get_input_names``), backed by ``serving.ServingEngine``. It is built
from a live ``GPT`` model, since the engine writes KV pages every tick::

    pred = ServingPredictor(model, max_new_tokens=64, num_slots=8,
                            page_size=16)
    out_ids, out_lens = pred.run([token_batch, lengths])

Restoring weights from a saved file (``state_path``) comes with the
checkpoint slice; use ``models.gpt.load_reference_state`` meanwhile.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["ServingPredictor"]


class ServingPredictor:
    """Predictor-shaped front end over ``serving.ServingEngine``."""

    def __init__(self, model, max_new_tokens: int = 32, **engine_knobs):
        from ..serving import ServingConfig, ServingEngine

        self.max_new_tokens = int(max_new_tokens)
        self.engine = ServingEngine(model, ServingConfig(**engine_knobs))

    def get_input_names(self) -> List[str]:
        return ["tokens", "lengths"]

    def run(self, inputs: Sequence[np.ndarray]):
        """inputs: ``[tokens [N, T] int, lengths [N] int (optional)]``.
        Rows are independent requests (``lengths`` strips right padding).
        Returns ``[ids [N, max_new_tokens], lengths [N]]``; rows that
        stopped early (EOS) are right-padded with the EOS id."""
        toks = np.asarray(inputs[0], np.int32)
        if toks.ndim != 2:
            raise ValueError("tokens must be [N, T]")
        n, t = toks.shape
        lens = (np.asarray(inputs[1], np.int64).reshape(-1)
                if len(inputs) > 1 else np.full(n, t, np.int64))
        rids = [self.engine.submit(toks[i, :int(lens[i])],
                                   self.max_new_tokens)
                for i in range(n)]
        results = self.engine.run()
        eos = self.engine.config.eos_token_id
        out = np.full((n, self.max_new_tokens),
                      eos if eos is not None else 0, np.int32)
        out_lens = np.zeros(n, np.int64)
        for i, rid in enumerate(rids):
            row = results[rid][:self.max_new_tokens]
            out[i, :row.shape[0]] = row
            out_lens[i] = row.shape[0]
        self.engine.reset_results()
        return [out, out_lens]

    __call__ = run
