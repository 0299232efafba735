"""Device mesh, process groups and tensor-parallel sharding (port of
vallex_tpu/parallel/mesh.py).

The port runs one process per device, so a mesh is a description: `dp`
data-parallel replicas × `tp` tensor-parallel shards over a device list,
rank r at (dp index r // tp, tp index r % tp) — the (dp, tp) reshape of
the JAX mesh, tp varying fastest. `init_process_groups` makes a rank's
torch.distributed world, its dp group (the ranks of its tp index) and its
tp group (the ranks of its dp index).

Tensor parallelism is Megatron's, with the JAX package's layout rule
(`param_partition_spec`, by the port's parameter names through convert.py's
name map): column-parallel fused QKV and FFN-up (with their biases),
row-parallel attention-out and FFN-down, vocab-sharded text and AR audio
embeddings, the NAR audio embeddings split by codebook and the NAR predict
heads by their input rows; everything else (norms, the AR head, small
tables) is replicated, as is a leaf whose split dimension does not divide.
Where JAX splits the fused QKV's 3·d columns contiguously, the port splits
Q, K and V each by heads: the same per-rank shape, so each rank attends
over its own H / tp heads. In the JAX package GSPMD inserts the
collectives; here the modules call them (parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import _leaf_name, jax_leaves
from .collectives import Group, TensorParallel


@dataclasses.dataclass
class Mesh:
    """dp × tp ranks over `devices` (device strings, one per rank)."""

    dp: int
    tp: int
    devices: List[str]
    # the serving worker pool of engine/batch.py, started on first use
    serving: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def ranks(self) -> np.ndarray:
        """[dp, tp] rank map: rank r sits at (r // tp, r % tp)."""
        return np.arange(self.size).reshape(self.dp, self.tp)

    def coords(self, rank: int) -> Tuple[int, int]:
        return rank // self.tp, rank % self.tp

    def close(self) -> None:
        """Stop the serving workers, if any ran."""
        if self.serving is not None:
            self.serving.close()
            self.serving = None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getstate__(self):
        return {**self.__dict__, "serving": None}


def _name(device) -> str:
    """"cuda" → "cuda:0": a rank's process has no current device to default to."""
    d = torch.device(device)
    return f"cuda:{d.index or 0}" if d.type == "cuda" else str(d)


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh over `devices` (default: every visible GPU)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n for CPU ranks")
    devices = [_name(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return Mesh(dp, tp, devices)


@dataclasses.dataclass
class Ranks:
    """One rank's place in the mesh and its groups."""

    mesh: Mesh
    rank: int
    device: torch.device
    dp: Group  # the ranks of this tp index (size mesh.dp)
    tp: TensorParallel  # the ranks of this dp index (size mesh.tp)

    @property
    def dp_rank(self) -> int:
        return self.mesh.coords(self.rank)[0]

    @property
    def tp_rank(self) -> int:
        return self.mesh.coords(self.rank)[1]


def init_process_groups(mesh: Mesh, rank: int, backend: Optional[str] = None,
                        init_method: Optional[str] = None) -> Ranks:
    """Join the world of `mesh.size` ranks as `rank` (nccl on CUDA, gloo on
    the CPU unless `backend` says) and make the dp and tp groups; every rank
    creates every group, in the same order."""
    import torch.distributed as dist

    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device for {device}")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=mesh.size, rank=rank)
    ranks = mesh.ranks
    dp_i, tp_i = mesh.coords(rank)

    def groups(members: List[List[int]], mine: int):
        if len(members[0]) == 1:
            return None
        if len(members) == 1:
            return dist.group.WORLD
        made = [dist.new_group(m) for m in members]
        return made[mine]

    dp_group = groups([list(ranks[:, t]) for t in range(mesh.tp)], tp_i)
    tp_group = groups([list(ranks[d, :]) for d in range(mesh.dp)], dp_i)
    return Ranks(mesh, rank, device, Group(dp_group, mesh.dp, dp_i),
                 TensorParallel(tp_group, mesh.tp, tp_i))


# ---------------------------------------------------------------------------
# The layout rule (vallex_tpu/parallel/mesh.py:43-66)
# ---------------------------------------------------------------------------

class Split(NamedTuple):
    """How a leaf splits over the mesh axis `axis`: along dimension `dim`
    of the JAX leaf (stacked leaves count their [NL] axis), in `parts`
    equal blocks that each split over the ranks (3 for the fused QKV)."""

    dim: int
    parts: int = 1
    axis: str = "tp"


def param_partition_spec(path: str) -> Optional[Split]:
    """The split of a parameter by name (the port's `ar_decoder.layers.0.
    self_attn.in_proj_w`, or the JAX tree's `ar_decoder/layers/self_attn/
    in_proj_w`), or None for a replicated one. Kernels are stored
    [in, out]."""
    p = _leaf_name(path.replace("/", ".")).replace(".", "/")
    lead = 1 if ("ar_decoder" in p or "nar_decoder" in p) else 0
    if "in_proj_w" in p:
        return Split(lead + 1, 3)  # column parallel, Q, K, V by heads
    if "linear1" in p and p.endswith("w"):
        return Split(lead + 1)  # column parallel
    if "out_w" in p or ("linear2" in p and p.endswith("w")):
        return Split(lead)  # row parallel
    if "in_proj_b" in p:
        return Split(lead, 3)
    if "linear1" in p and p.endswith("b"):
        return Split(lead)
    if ("_embedding" in p and p.endswith("weight") and "language" not in p
            and "stage" not in p):
        return Split(0)  # vocab-sharded tables; the NAR's by codebook
    if "predict_layer" in p and p.endswith("w"):
        return Split(1)  # the NAR heads by input rows (the AR head: 1025 columns)
    return None


def leaf_split(path: str, shape: Sequence[int], tp: int) -> Optional[Split]:
    """param_partition_spec, or None where the split dimension does not
    divide (replicated, as shard_params's fallback at :84-89)."""
    split = param_partition_spec(path)
    if split is None or tp == 1:
        return None
    n = shape[split.dim]
    if n % split.parts or (n // split.parts) % tp:
        return None
    return split


def local_part(t: torch.Tensor, dim: int, parts: int, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s slice of a full tensor: each of `parts` blocks along
    `dim` split in `size`, the rank's pieces side by side."""
    return torch.cat([c.chunk(size, dim)[rank] for c in t.chunk(parts, dim)], dim)


def full_part(local: torch.Tensor, dim: int, parts: int, group: Group) -> torch.Tensor:
    """The inverse of local_part over the group: each rank writes its
    pieces into a zero-filled full tensor and an all-reduce sums them."""
    n = local.shape[dim] // parts
    shape = list(local.shape)
    shape[dim] *= group.size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    for j, piece in enumerate(local.split(n, dim)):
        full.narrow(dim, (j * group.size + group.rank) * n, n).copy_(piece)
    return group.sum_(full)


class _Unbound:
    """Stands for the tp group of a model sharded for its shapes alone."""

    def copy(self, x):
        raise RuntimeError("a sharded model runs with its rank's groups: "
                           "shard_params(model, mesh, tp_rank, ranks)")

    reduce = copy


def shard_params(model: torch.nn.Module, mesh: Mesh, tp_rank: int,
                 ranks: Optional[Ranks] = None) -> torch.nn.Module:
    """Make `model` (a VALLE holding the full parameters, any device) rank
    `tp_rank`'s local model, in place: every split leaf keeps its slice,
    the attention layers their H / tp heads, and the modules that hold a
    slice call the tp collectives of `ranks` (without `ranks` the model is
    good for its shapes only). Sets `model.par = ranks` and
    `model.tp_specs` ({JAX leaf name: Split})."""
    from ..models import layers as L
    from ..models import vallex as V

    tp = mesh.tp
    specs: Dict[str, Split] = {}
    for name, (params, stacked) in jax_leaves(model).items():
        shape = ((len(params),) if stacked else ()) + tuple(params[0].shape)
        split = leaf_split(name, shape, tp)
        if split is None:
            continue
        specs[name] = split
        for p in params:
            p.data = local_part(p.data, split.dim - int(stacked), split.parts,
                                tp_rank, tp).contiguous()
    model.tp_specs = specs
    model.par = ranks
    if not specs:
        model.tp = None
        return model
    if "ar_predict_layer.w" in specs:
        raise ValueError(f"tp={tp} splits the AR head's {model.cfg.num_audio_tokens + 1}"
                         " columns; the port keeps it replicated")
    if model.cfg.num_heads % tp:
        raise ValueError(f"{model.cfg.num_heads} heads do not split over tp={tp}")
    group = ranks.tp if ranks is not None else _Unbound()
    model.tp = group
    for mname, mod in model.named_modules():
        leaf = _leaf_name(mname)
        if isinstance(mod, L.MultiheadAttention) and f"{leaf}.in_proj_w" in specs:
            mod.num_heads //= tp
            mod.tp = group
        elif isinstance(mod, L.Linear) and f"{leaf}.w" in specs:
            # [in, out] kernels: rows split → row parallel, columns → column
            in_dim = specs[f"{leaf}.w"].dim - int(leaf != mname) == 0
            mod.tp, mod.tp_mode = group, ("row" if in_dim else "col")
        elif isinstance(mod, V.Embedding) and f"{leaf}.weight" in specs:
            mod.tp, mod.vocab_start = group, tp_rank * mod.weight.shape[0]
    if "nar_audio_embeddings.weight" in specs:
        model.nar_codebook_start = tp_rank * model.nar_audio_embeddings.weight.shape[0]
    if "nar_predict_layers.w" in specs:
        model.nar_head_rows = tp_rank * model.nar_predict_layers.w.shape[1]
    return model


def _moments(state: Dict[str, Any], leaves, fn) -> Dict[str, Any]:
    """Map fn(leaf, tensor) over the per-leaf lists of an optimizer state
    (`mu`, `nu`: [[tensor per parameter of the leaf] per leaf]); counts and
    other entries pass through."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list) and len(v) == len(leaves) and all(
                isinstance(x, list) for x in v):
            v = [[fn(leaf, t) for t in ts] for leaf, ts in zip(leaves, v)]
        out[k] = v
    return out


def _param_dim(leaf) -> int:
    return leaf.split.dim - (leaf.ndim - leaf.params[0].ndim)


def shard_tree(state: Dict[str, Any], leaves, tp_rank: int, tp: int) -> Dict[str, Any]:
    """A full optimizer state → rank `tp_rank`'s: each moment follows its
    parameter's split (`leaves` as the optimizer sees them, from
    train/step.py::model_leaves of the sharded model)."""
    def cut(leaf, t):
        if leaf.split is None:
            return t
        return local_part(t, _param_dim(leaf), leaf.split.parts, tp_rank, tp).contiguous()

    return _moments(state, leaves, cut)


def gather_tree(state: Dict[str, Any], leaves) -> Dict[str, Any]:
    """The inverse of shard_tree, by all-reduce over each leaf's tp group
    (every tp rank calls it)."""
    def put(leaf, t):
        if leaf.split is None:
            return t
        return full_part(t, _param_dim(leaf), leaf.split.parts, leaf.tp)

    return _moments(state, leaves, put)


def gather_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The full parameters of a sharded model by the port's names (the
    single-process `state_dict()`), on its device; every tp rank calls it."""
    specs = getattr(model, "tp_specs", {})
    out = {}
    for name, p in model.named_parameters():
        leaf = _leaf_name(name)
        split = specs.get(leaf)
        t = p.detach()
        if split is not None:
            stacked = leaf != name
            t = full_part(t, split.dim - int(stacked), split.parts, model.tp)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# Data parallelism: each dp rank takes its rows of the global batch
# ---------------------------------------------------------------------------

def dp_rows(n: int, dp_rank: int, dp: int) -> Tuple[int, int]:
    """[start, stop) of dp rank `dp_rank`'s rows among n (np.array_split's
    split: the first n % dp ranks take one more; a rank may take none)."""
    base, extra = divmod(n, dp)
    start = dp_rank * base + min(dp_rank, extra)
    return start, start + base + (dp_rank < extra)


def dp_batch(batch: Dict[str, Any], dp_rank: int, dp: int) -> Dict[str, Any]:
    """A collated batch (numpy) → dp rank `dp_rank`'s rows. A packed batch
    (collate_packed) splits by packed rows, with the per-utterance
    `audio_lens` of its rows; `utt_ids` follow."""
    if dp == 1:
        return batch
    packed = "p_text_ids" in batch
    rows = batch["p_text_ids" if packed else "text_ids"].shape[0]
    start, stop = dp_rows(rows, dp_rank, dp)
    utt = (start, stop)
    if packed:  # utterances per row: the segment ids of its audio region
        per_row = batch["p_audio_seg"].max(axis=1).astype(np.int64)
        utt = (int(per_row[:start].sum()), int(per_row[:stop].sum()))
    out = {}
    for k, v in batch.items():
        if k in ("audio_lens", "utt_ids") and packed:
            out[k] = v[utt[0]: utt[1]]
        elif isinstance(v, (np.ndarray, list)):
            out[k] = v[start:stop]
        else:
            out[k] = v
    return out
