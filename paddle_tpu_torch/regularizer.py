"""Regularizers.

Counterpart: ``paddle_tpu/regularizer.py``. A parameter's regularizer
(`ParamAttr(regularizer=...)`) gives its weight decay: the optimizers
read ``_coeff`` alone, as the reference's do, L1 or L2 alike.
"""


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff
        self._l1 = True


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = coeff
        self._l1 = False


__all__ = ["L1Decay", "L2Decay"]
