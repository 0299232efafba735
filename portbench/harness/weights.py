"""Weights made from the seed, on the device, in the layout
`vallex_tpu_torch.api.preload_models` takes (`params`, `vocos_params`).

All uniform leaves of a model come from one `torch.rand` call and all normal
leaves from one `torch.randn` call on a generator of the device, then are
sliced, scaled and cast to the type they are served in. The distributions
are torch's default initialisations, as the program's own random init
draws them (Linear U(±1/√in), the fused QKV Xavier-uniform, embeddings
N(0, 1), LayerNorms one and zero, the NAR's heads 0-5 tied to its audio
embeddings 2-7), except where the configuration's file lists otherwise
under `assumed`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, tuple, str, float]  # (path, shape, kind, bound or std)


class _Draw:
    """Collects leaf specs, then fills them from two large draws."""

    def __init__(self):
        self.specs: List[Spec] = []

    def add(self, path: str, shape, kind: str, a: float = 0.0):
        self.specs.append((path, tuple(shape), kind, a))

    def build(self, gen: torch.Generator, device, dtype) -> Dict:
        n_u = sum(math.prod(s) for _, s, k, _ in self.specs if k == "uniform")
        n_n = sum(math.prod(s) for _, s, k, _ in self.specs if k == "normal")
        uni = torch.rand(n_u, generator=gen, device=device) * 2 - 1
        nor = torch.randn(n_n, generator=gen, device=device)
        tree: Dict = {}
        ou = on = 0
        for path, shape, kind, a in self.specs:
            size = math.prod(shape)
            if kind == "uniform":
                leaf = uni[ou: ou + size].view(shape) * a
                ou += size
            elif kind == "normal":
                leaf = nor[on: on + size].view(shape) * a
                on += size
            else:
                leaf = torch.full(shape, a, device=device)
            node = tree
            *parents, name = path.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = leaf.to(dtype)
        return tree


def _stack(d: _Draw, prefix: str, NL: int, D: int, F: int, adaptive: bool):
    xav = math.sqrt(6.0 / (D + 3 * D))
    d.add(f"{prefix}/layers/self_attn/in_proj_w", (NL, D, 3 * D), "uniform", xav)
    d.add(f"{prefix}/layers/self_attn/in_proj_b", (NL, 3 * D), "const", 0.0)
    d.add(f"{prefix}/layers/self_attn/out_w", (NL, D, D), "uniform", 1 / math.sqrt(D))
    d.add(f"{prefix}/layers/self_attn/out_b", (NL, D), "const", 0.0)
    d.add(f"{prefix}/layers/linear1/w", (NL, D, F), "uniform", 1 / math.sqrt(D))
    d.add(f"{prefix}/layers/linear1/b", (NL, F), "uniform", 1 / math.sqrt(D))
    d.add(f"{prefix}/layers/linear2/w", (NL, F, D), "uniform", 1 / math.sqrt(F))
    d.add(f"{prefix}/layers/linear2/b", (NL, D), "uniform", 1 / math.sqrt(F))
    for norm, lead in ((f"{prefix}/layers/norm1", (NL,)), (f"{prefix}/layers/norm2", (NL,)),
                       (f"{prefix}/norm", ())):
        d.add(f"{norm}/scale", (*lead, D), "const", 1.0)
        d.add(f"{norm}/bias", (*lead, D), "const", 0.0)
        if adaptive:
            d.add(f"{norm}/w", (*lead, D, 2 * D), "uniform", 1 / math.sqrt(D))
            d.add(f"{norm}/b", (*lead, 2 * D), "uniform", 1 / math.sqrt(D))


def vallex_tree(model: Dict, weights: Dict, gen: torch.Generator, device, dtype) -> Dict:
    """The VALL-E X tree for the configuration's `model` sizes and its
    `weights` settings."""
    D, F, NL = model["d_model"], model["ffn_dim"], model["num_layers"]
    q, A = model["num_quantizers"], model["num_audio_tokens"]
    V, nl = model["num_text_tokens"], model["num_languages"]
    d = _Draw()
    for stack in ("ar", "nar"):
        d.add(f"{stack}_text_embedding/weight", (V, D), "normal", 1.0)
        d.add(f"{stack}_language_embedding/weight", (nl, D), "normal", 1.0)
        d.add(f"{stack}_text_position/alpha", (), "const", 1.0)
        d.add(f"{stack}_audio_position/alpha", (), "const", 1.0)
    d.add("ar_audio_embedding/weight", (A + 2, D), "normal", 1.0)
    _stack(d, "ar_decoder", NL, D, F, adaptive=False)
    _stack(d, "nar_decoder", NL, D, F, adaptive=True)
    d.add("ar_predict_layer/w", (D, A + 1), "uniform", math.sqrt(6.0 / (D + A + 1)))
    d.add("nar_audio_embeddings/weight", (q, A + 1, D), "normal", 1.0)
    d.add("nar_last_head", (D, A), "uniform", math.sqrt(6.0 / (D + A)))
    d.add("nar_stage_embeddings/weight", (q - 1, D), "normal", 1.0)
    tree = d.build(gen, device, dtype)
    emb = tree["nar_audio_embeddings"]["weight"]
    emb[1:, A] = 0  # codebooks 1..7 have no EOS row
    heads = emb[2:, :A].transpose(1, 2)  # heads 0-5 tied to embeddings 2-7
    tree["nar_predict_layers"] = {"w": torch.cat([heads, tree.pop("nar_last_head")[None]])}
    # random weights would draw EOS by chance and stop a request anywhere, so
    # each seed would do other work; with the AR's final LayerNorm bias at
    # `eos_bias` and the head's EOS column at -`eos_weight`, EOS's logit is
    # -eos_weight · eos_bias · D (LayerNorm rows sum to 0) and every
    # request runs to its cap
    tree["ar_decoder"]["norm"]["bias"].fill_(weights["eos_bias"])
    tree["ar_predict_layer"]["w"][:, A].fill_(-weights["eos_weight"])
    return tree


def vocos_tree(vocos: Dict, gen: torch.Generator, device) -> Dict:
    """The Vocos tree (float32, as it is served) for the configuration's
    `vocos` sizes: truncated-normal std 0.02 weights (clipped at 2σ), N(0, 1)
    codebooks, and AdaLN tables and layer scales drawn as `assumed` says."""
    C, Dm, I = vocos["input_channels"], vocos["dim"], vocos["intermediate_dim"]
    L, nb, nq = vocos["num_layers"], vocos["num_bandwidths"], vocos["num_codebooks"]
    K, n_out = vocos["kernel"], vocos["n_fft"] + 2
    g_lo, g_hi = vocos["layer_scale_range"]
    ada = vocos["ada_norm_std"]
    d = _Draw()
    d.add("codebook_weights", (nq, vocos["codebook_size"], C), "normal", 1.0)
    d.add("embed/w", (K, C, Dm), "normal", 0.02)
    d.add("embed/b", (Dm,), "const", 0.0)
    d.add("norm/scale_noise", (nb, Dm), "normal", ada)
    d.add("norm/shift", (nb, Dm), "normal", ada)
    d.add("blocks/dwconv/w", (L, K, 1, Dm), "normal", 0.02)
    d.add("blocks/dwconv/b", (L, Dm), "const", 0.0)
    d.add("blocks/norm/scale_noise", (L, nb, Dm), "normal", ada)
    d.add("blocks/norm/shift", (L, nb, Dm), "normal", ada)
    d.add("blocks/pwconv1/w", (L, Dm, I), "normal", 0.02)
    d.add("blocks/pwconv1/b", (L, I), "const", 0.0)
    d.add("blocks/pwconv2/w", (L, I, Dm), "normal", 0.02)
    d.add("blocks/pwconv2/b", (L, Dm), "const", 0.0)
    d.add("blocks/gamma_unit", (L, Dm), "uniform", 1.0)
    d.add("final_norm/scale", (Dm,), "const", 1.0)
    d.add("final_norm/bias", (Dm,), "const", 0.0)
    d.add("head/w", (Dm, n_out), "normal", 0.02)
    d.add("head/b", (n_out,), "const", 0.0)
    t = d.build(gen, device, torch.float32)
    for path in ("embed/w", "blocks/dwconv/w", "blocks/pwconv1/w", "blocks/pwconv2/w",
                 "head/w"):
        node, name = t, path
        for key in path.split("/")[:-1]:
            node = node[key]
        name = path.split("/")[-1]
        node[name] = node[name].clamp_(-0.04, 0.04)
    for node in (t["norm"], t["blocks"]["norm"]):
        node["scale"] = 1.0 + node.pop("scale_noise")
    unit = t["blocks"].pop("gamma_unit")  # U(-1, 1) → U(g_lo, g_hi)
    t["blocks"]["gamma"] = g_lo + (unit + 1) * 0.5 * (g_hi - g_lo)
    return t
