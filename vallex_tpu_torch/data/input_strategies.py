"""Prompted-features container (reference: data/input_strategies.py:16-35;
port of vallex_tpu/data/input_strategies.py).

Pairs (prompt, target) feature tensors through collation. The reference's
lhotse-based PromptedPrecomputedFeatures is commented out upstream and not
reproduced; the HDF5 pipeline of data/dataset.py is the supported path."""

from __future__ import annotations

from typing import Tuple


class PromptedFeatures:
    def __init__(self, prompts, features):
        self.prompts = prompts
        self.features = features

    def to(self, device):
        return PromptedFeatures(self.prompts.to(device), self.features.to(device))

    def sum(self):
        return self.features.sum()

    @property
    def ndim(self):
        return self.features.ndim

    @property
    def data(self) -> Tuple:
        return (self.prompts, self.features)
