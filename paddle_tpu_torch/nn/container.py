"""Layer containers: `Sequential`, `LayerList`, `LayerDict`,
`ParameterList`.

Counterpart: ``paddle_tpu/nn/container.py``. Each is an `nn.Layer`
whose entries are its sublayers (or parameters) under the reference's
names: ``"0"``, ``"1"``, ... in order, or the names given.
"""
from __future__ import annotations

from collections import OrderedDict

from .layer import Layer


class Sequential(Layer):
    """``Sequential(l0, l1, ...)``, ``Sequential(OrderedDict(name=l))`` or
    ``Sequential(("name", l), ...)``; ``forward`` runs them in turn."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        elif len(layers) and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) == 2 and isinstance(layers[0][0], str):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for idx, layer in enumerate(layers):
                self.add_sublayer(str(idx), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, input):
        for layer in self._modules.values():
            input = layer(input)
        return input


class LayerList(Layer):
    """A list of sublayers, named by index."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for idx, layer in enumerate(sublayers):
                self.add_sublayer(str(idx), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx if idx >= 0 else len(self) + idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class LayerDict(Layer):
    """A dict of sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        if isinstance(sublayers, dict):
            sublayers = sublayers.items()
        for key, layer in sublayers:
            self.add_sublayer(key, layer)


class ParameterList(Layer):
    """A list of parameters, named by index."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for idx, p in enumerate(parameters):
                self.add_parameter(str(idx), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx if idx >= 0 else len(self) + idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]
