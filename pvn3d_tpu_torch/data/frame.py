"""Batching of per-frame sample dicts.

Port of ``collate`` from the JAX package's ``data/frame.py`` (its sample
construction and the loaders beside it are not ported yet).
"""
from __future__ import annotations

import numpy as np


def collate(samples) -> dict:
    """Stack a list of sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
