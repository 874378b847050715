"""``ParamAttr`` (mirrors ``paddle_tpu/framework/param_attr.py``;
reference: python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """None | False | str | Initializer | ParamAttr -> ParamAttr or
        None (False: no parameter)."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)
