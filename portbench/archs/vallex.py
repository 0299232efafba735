"""VALL-E X (Plachtaa/VALL-E-X models/vallex.py), the architecture of a
configuration that names none: the harness's existing weights, reference
and counts behind the names every architecture gives (README.md, "Adding
a model architecture").

- `draw_tree(model, weights, gen, device, dtype)`: the model's tree from
  the generator (harness/weights.py);
- `program_config(model)`: the program's ModelConfig for the sizes;
- `reference(tree, model)`: the plain float32 model (reference/vallex.py)
  with `device`, `eos`, `ar_logits` and `nar_logits`;
- `request_flops`, `gemm_small_m_bound_s`, `masked_attention_bound_s`:
  roofline/counts.py.
"""

from portbench.harness.weights import vallex_tree as draw_tree  # noqa: F401
from portbench.reference import vallex as RV
from portbench.reference.quant import FLOAT32
from portbench.roofline.counts import (gemm_small_m_bound_s, masked_attention_bound_s,  # noqa: F401
                                       request_flops)


def program_config(model):
    from vallex_tpu_torch.config import ModelConfig

    return ModelConfig(**model)


class Reference:
    """RV.Model with the teacher-forced AR and the NAR as methods."""

    def __init__(self, tree, model):
        self.m = RV.Model(tree, model["num_heads"])
        self.device, self.eos = self.m.device, self.m.eos

    def ar_logits(self, text, lang, prompt_cb0, tokens, prec=FLOAT32):
        return RV.ar_logits(self.m, text, lang, prompt_cb0, tokens, prec)

    def nar_logits(self, text, lang, codes, Tp, prec=FLOAT32):
        return RV.nar_logits(self.m, text, lang, codes, Tp, prec)


def reference(tree, model):
    return Reference(tree, model)
