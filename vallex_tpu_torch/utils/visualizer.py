"""Training-debug visualizer: per-utterance heatmap PNGs (port of
vallex_tpu/utils/visualizer.py; reference: models/visualizer.py:26-106).

Writes the encoder- and decoder-side activations and the target codes of
the first few utterances of a batch as matplotlib heatmaps. matplotlib is
imported when `visualize` runs, with the Agg backend; without it the call
raises an ImportError that names it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize needs matplotlib (pip install matplotlib)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _heatmap(plt, mat: np.ndarray, title: str, path: str, size, cmap: str,
             labels: bool) -> None:
    fig = plt.figure(figsize=size)
    plt.imshow(mat.T, aspect="auto", origin="lower", cmap=cmap)
    plt.colorbar()
    plt.title(title)
    if labels:
        plt.xlabel("frame")
        plt.ylabel("dim")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def visualize(
    predicts,  # (encoder-side [B, S, D], decoder-side [B, T, D]), arrays or tensors
    batch: Dict,  # "codes" [B, T, 8] and "utt_ids" are used when present
    output_dir: str,
    limit: int = 4,
) -> None:
    """`<utt>_encoder.png`, `<utt>_decoder.png` and (with codes)
    `<utt>_codes.png` in output_dir for the first `limit` utterances."""
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    enc, dec = (np.asarray(_numpy(p), np.float32) for p in predicts[:2])
    codes = np.asarray(_numpy(batch["codes"])) if "codes" in batch else None
    utt_ids = batch.get("utt_ids") or [f"utt{i}" for i in range(len(enc))]
    for b in range(min(limit, len(enc))):
        uid = utt_ids[b]
        for name, mat in (("encoder", enc[b]), ("decoder", dec[b])):
            _heatmap(plt, mat, f"{uid} {name} output",
                     os.path.join(output_dir, f"{uid}_{name}.png"), (16, 8), "viridis", True)
        if codes is not None:
            _heatmap(plt, codes[b], f"{uid} target codes",
                     os.path.join(output_dir, f"{uid}_codes.png"), (16, 4), "magma", False)


def _numpy(x):
    """A tensor (any device or dtype) or array → numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return x
