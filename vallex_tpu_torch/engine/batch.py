"""Batch-parallel synthesis over a mesh of devices (port of
vallex_tpu/engine/batch.py).

Independent requests scale across devices: one worker process per device
of the mesh (`tp` 1, as the JAX serve mesh), each holding its own
SynthesisPipeline built once from a CPU copy of the model's parameters,
each running its own requests with no collectives (the JAX package's
shard_map over "dp" with nothing shared inside). The pool starts on the
first call, is reused by later ones with the same model and engine
config, and closes with the mesh (`mesh.close()`, its context manager, or
at exit). With one device the work runs in the calling process.

Padding and buckets are the JAX package's, over the whole batch (s_text,
p_audio, t_gen and t_audio; p_audio ABLK-aligned when per_chip > 1, capped
at t_audio when 1; EOS-padded cb0 prompts; seeds arange(rows) by default),
so greedy codes equal the JAX package's. Sampled modes draw from a
torch.Generator seeded by the request's seed (per_chip 1) or by the
chunk's seeds (per_chip > 1), in the port's own order: their draws are
distributional, not JAX's.
"""

from __future__ import annotations

import atexit
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..models import vallex as V
from .ar import ABLK, bucket, single_request_gen_caps

Request = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]  # text, lang, prompt [Tp, 8]


def _chunk_seed(seeds: Sequence[int]) -> int:
    """One generator seed from a chunk's request seeds (every one counts)."""
    s = 0
    for x in seeds:
        s = (s * 1_000_003 + int(x)) & 0x7FFFFFFF
    return s


def _pipeline(model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig):
    from .pipeline import SynthesisPipeline

    return SynthesisPipeline(model, cfg, ecfg)


def _run(pipe, task) -> Tuple[np.ndarray, np.ndarray]:
    """One task on one device → (codes [R, t_audio, 8] with each request's
    generated frames at rows [prompt_len, prompt_len + gen_len), gen_lens [R])."""
    kind, a = task
    rows = len(a["x_lens"])
    t_audio = a["prompt_codes"].shape[1]
    codes = a["prompt_codes"].astype(np.int64).copy()
    lens = np.zeros((rows,), np.int32)
    if kind == "one":
        for r in range(rows):
            x, pl = int(a["x_lens"][r]), int(a["prompt_lens"][r])
            res = pipe.synthesize(
                a["text"][r, :x], a["lang"][r, :x],
                a["prompt_codes"][r, :pl] if pl else None, seed=int(a["seeds"][r]),
                return_wave=False, buckets=(a["s_text"], a["p_audio"], t_audio))
            lens[r] = len(res.codes)
            codes[r, pl: pl + len(res.codes)] = res.codes
        return codes, lens
    e = pipe.ecfg
    pb = dict(s_text=a["s_text"], p_audio=a["p_audio"], t_gen=a["t_gen"], text=a["text"],
              lang=a["lang"], x_lens=a["x_lens"], prompt_pad=a["prompt_cb0"],
              prompt_lens=a["prompt_lens"], caps=a["caps"])
    _, gen, gl, _ = pipe.decode_padded_batch(
        pb, a["prompt_codes"], best_of=1, top_k=e.top_k, top_p=e.top_p,
        temperature=e.temperature, seed=_chunk_seed(a["seeds"]))
    gen = gen.cpu().numpy()
    for r in range(rows):
        pl, n = int(a["prompt_lens"][r]), int(gl[r])
        codes[r, pl: pl + n] = gen[r, :n]
        lens[r] = n
    return codes, lens


def serve_worker(conn, device: str, state: Dict[str, torch.Tensor], cfg: ModelConfig,
                 ecfg: EngineConfig, threads: Optional[int]) -> None:
    """A worker process (parallel/launch.py): build the pipeline on `device`
    from the CPU state dict, then answer tasks until None arrives. Each
    answer is ((codes, gen_lens), launch counts by "kernel@site", seconds)."""
    from ..kernels import loader

    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    model = _model_from_state(cfg, state, dev)
    del state
    pipe = _pipeline(model, cfg, ecfg)
    conn.send(("ok", "ready"))
    while True:
        task = conn.recv()
        if task is None:
            return
        loader.reset_launch_counts()
        t0 = time.perf_counter()
        out = _run(pipe, task)
        conn.send(("ok", (out, {f"{k}@{s}": n for (k, s), n in loader.launch_counts.items()},
                           time.perf_counter() - t0)))


def _model_from_state(cfg: ModelConfig, state: Dict[str, torch.Tensor], device) -> V.VALLE:
    model = V.VALLE(cfg)
    for name, p in model.named_parameters():
        p.data = state[name].to(device)
    for name, b in model.named_buffers():
        model.get_buffer(name).data = b.to(device=device, dtype=torch.float32)
    return model


@dataclasses.dataclass
class _Pool:
    """The mesh's serving workers, one per device."""

    key: tuple
    children: list
    last_launches: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    last_seconds: List[float] = dataclasses.field(default_factory=list)

    def run(self, tasks: List[Optional[tuple]]) -> List[Optional[Tuple]]:
        from ..parallel.launch import gather

        busy = [i for i, t in enumerate(tasks) if t is not None]
        for i in busy:
            self.children[i].put(tasks[i])
        answers = gather([self.children[i] for i in busy])
        out: List[Optional[Tuple]] = [None] * len(tasks)
        self.last_launches, self.last_seconds = [], []
        for i, (res, launches, secs) in zip(busy, answers):
            out[i] = res
            self.last_launches.append(launches)
            self.last_seconds.append(secs)
        return out

    def close(self) -> None:
        for c in self.children:
            c.close()
        self.children = []


def _pool(mesh, model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig) -> _Pool:
    """The mesh's worker pool for (model, ecfg), started on first use."""
    from ..parallel.launch import Child, gather

    key = (id(model), cfg, ecfg)
    if mesh.serving is not None and mesh.serving.key == key:
        return mesh.serving
    mesh.close()
    if any(torch.device(d).type == "cuda" for d in mesh.devices):
        from ..kernels import loader

        loader.build()  # once, before the workers load it
    state = {n: p.detach().cpu() for n, p in model.named_parameters()}
    threads = 1 if all(torch.device(d).type == "cpu" for d in mesh.devices) else None
    children = [Child(serve_worker, (d, state, cfg, ecfg, threads), threads)
                for d in mesh.devices]
    try:
        for c in children:
            c.start()
        gather(children)  # "ready"
    except BaseException:
        for c in children:
            c.close()
        raise
    mesh.serving = _Pool(key, children)
    atexit.register(mesh.close)
    return mesh.serving


class _Local:
    """A one-device mesh's pipeline, in the calling process."""

    def __init__(self, key, pipe):
        self.key, self.pipe = key, pipe

    def run(self, tasks: List[Optional[tuple]]) -> List[Optional[Tuple]]:
        return [None if t is None else _run(self.pipe, t) for t in tasks]

    def close(self) -> None:
        self.pipe = None


def _serve(model, cfg, ecfg, mesh, tasks: List[Optional[tuple]]):
    """Each device's task → its (codes, gen_lens) (None where it had none)."""
    if mesh.tp != 1:
        raise ValueError(f"serving runs on a dp mesh (tp 1), got tp={mesh.tp}")
    if mesh.dp > 1:
        return _pool(mesh, model, cfg, ecfg).run(tasks)
    key = (id(model), cfg, ecfg)
    if mesh.serving is None or mesh.serving.key != key:
        mesh.close()
        dev = torch.device(mesh.devices[0])
        local = model if model.pe.device == dev else _model_from_state(
            cfg, {n: p.detach() for n, p in model.named_parameters()}, dev)
        mesh.serving = _Local(key, _pipeline(local, cfg, ecfg))
    return mesh.serving.run(tasks)


def _split(arrays: Dict, rows: List[range], kind: str, common: Dict) -> List[Optional[tuple]]:
    return [(kind, {**common, **{k: v[r.start: r.stop] for k, v in arrays.items()}})
            if len(r) else None for r in rows]


def make_chunked_synthesis(model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig, mesh, *,
                           s_text: int, p_audio: int, t_gen: int, t_audio: int,
                           per_chip: int):
    """Synthesis with in-device batching: each device runs the batched
    engine (ar_generate_batch, then the batched NAR) over its own chunk of
    per_chip rows, so the mesh serves devices × per_chip streams.

    Returns fn(text [N,S], lang [N,S], x_lens [N], prompt_cb0 [N,p_audio-1],
    prompt_codes [N,t_audio,8], prompt_lens [N], gen_caps [N], seeds [N]) →
    (codes [N,t_audio,8], gen_lens [N]), request i's generated frames at
    rows [prompt_lens[i], prompt_lens[i] + gen_lens[i]); N <= devices ·
    per_chip, device d taking rows [d·per_chip, (d+1)·per_chip)."""
    common = dict(s_text=s_text, p_audio=p_audio, t_gen=t_gen)

    def fn(text, lang, x_lens, prompt_cb0, prompt_codes, prompt_lens, gen_caps, seeds):
        n = len(x_lens)
        rows = [range(min(d * per_chip, n), min((d + 1) * per_chip, n))
                for d in range(mesh.dp)]
        arrays = dict(text=text, lang=lang, x_lens=x_lens, prompt_cb0=prompt_cb0,
                      prompt_codes=prompt_codes, prompt_lens=prompt_lens, caps=gen_caps,
                      seeds=seeds)
        outs = _serve(model, cfg, ecfg, mesh, _split(arrays, rows, "chunk", common))
        got = [o for o in outs if o is not None]
        return np.concatenate([c for c, _ in got]), np.concatenate([g for _, g in got])

    return fn


def make_batched_synthesis(model: V.VALLE, cfg: ModelConfig, ecfg: EngineConfig, mesh, *,
                           s_text: int, p_audio: int, t_audio: int,
                           decode_mode: str = "xla"):
    """Synthesis of one request per device, each through
    SynthesisPipeline.synthesize at these buckets (ar_generate, then
    nar_generate), with EngineConfig.decode_mode = decode_mode.

    Returns fn(text [N,S], lang [N,S], x_lens [N], prompt_cb0 [N,p_audio-1],
    prompt_codes [N,t_audio,8], prompt_lens [N], seeds [N]) → (codes
    [N,t_audio,8], gen_lens [N]) as make_chunked_synthesis's; N <= devices."""
    ecfg = dataclasses.replace(ecfg, decode_mode=decode_mode)
    common = dict(s_text=s_text, p_audio=p_audio)

    def fn(text, lang, x_lens, prompt_cb0, prompt_codes, prompt_lens, seeds):
        n = len(x_lens)
        rows = [range(min(d, n), min(d + 1, n)) for d in range(mesh.dp)]
        arrays = dict(text=text, lang=lang, x_lens=x_lens, prompt_codes=prompt_codes,
                      prompt_lens=prompt_lens, seeds=seeds)
        outs = _serve(model, cfg, ecfg, mesh, _split(arrays, rows, "one", common))
        got = [o for o in outs if o is not None]
        return np.concatenate([c for c, _ in got]), np.concatenate([g for _, g in got])

    return fn


def pad_batch(cfg: ModelConfig, ecfg: EngineConfig, requests: Sequence[Request], *,
              seeds: Optional[Sequence[int]] = None, per_chip: int = 1,
              n_rows: Optional[int] = None) -> Dict:
    """The JAX package's padding and buckets over the whole batch →
    {s_text, p_audio, t_gen, t_audio, and [N, ...] arrays text, lang,
    x_lens, prompt_cb0 (EOS-padded), prompt_codes, prompt_lens, caps
    (per_chip > 1) and seeds (default: the row index)}."""
    N = len(requests)
    max_s = max(len(t) for t, _, _ in requests)
    max_tp = max(
        (0 if p is None else len(p)) for _, _, p in requests
    )
    s_text = bucket(max_s, ecfg.text_buckets)
    if per_chip > 1:
        p_audio = -(-(max_tp + 1) // ABLK) * ABLK
    else:
        p_audio = bucket(max_tp + 1, ecfg.audio_buckets)
    t_gen = bucket(
        min(16 * max_s + 1, ecfg.audio_buckets[-1]), ecfg.audio_buckets,
        granularity=512,
    )
    t_audio = bucket(
        min(max_tp + 1 + 16 * max_s + 1, ecfg.audio_buckets[-1]),
        ecfg.audio_buckets,
        granularity=512,
    )
    if per_chip == 1:
        p_audio = min(p_audio, t_audio)

    text = np.zeros((N, s_text), np.int32)
    lang = np.zeros((N, s_text), np.int32)
    x_lens = np.ones((N,), np.int32)
    # EOS-pad the codebook-0 prompt slots (see AREngine.generate: unwritten
    # pad slots must not count as generated frames)
    pcb0 = np.full((N, p_audio - 1), cfg.eos_id, np.int32)
    pcodes = np.zeros((N, t_audio, cfg.num_quantizers), np.int32)
    plens = np.zeros((N,), np.int32)
    seed_arr = np.arange(max(N, n_rows or N), dtype=np.int32)
    if seeds is not None:
        seed_arr[: len(seeds)] = seeds

    for i, (t, l, p) in enumerate(requests):  # noqa: E741
        text[i, : len(t)] = t
        lang[i, : len(l)] = l
        x_lens[i] = len(t)
        if p is not None:
            pcb0[i, : len(p)] = p[:, 0]
            pcodes[i, : len(p)] = p
            plens[i] = len(p)
    caps = (single_request_gen_caps(plens, x_lens, ecfg.audio_buckets) if per_chip > 1
            else None)
    return dict(s_text=s_text, p_audio=p_audio, t_gen=t_gen, t_audio=t_audio, text=text,
                lang=lang, x_lens=x_lens, prompt_cb0=pcb0, prompt_codes=pcodes,
                prompt_lens=plens, caps=caps, seeds=seed_arr[:N])


def batch_synthesize(
    model: V.VALLE,
    cfg: ModelConfig,
    ecfg: EngineConfig,
    mesh,
    requests: Sequence[Request],
    *,
    seeds: Optional[Sequence[int]] = None,
    decode_mode: str = "xla",
    per_chip: int = 1,
) -> List[np.ndarray]:
    """Synthesize N (text_ids, lang_ids, prompt_codes|None) requests across
    the mesh (parallel/mesh.py, tp 1) → list of [T_i, 8] code arrays.

    per_chip > 1 composes the mesh with in-device batching: each device
    serves its own chunk of per_chip requests through the batched engine
    (devices × per_chip concurrent streams), whose decode runs
    ops/decode_block.py whatever `decode_mode` says (kernels on CUDA, their
    plain versions on the CPU). `mesh.serving.last_launches` holds each
    worker's kernel launches by site in the last call."""
    ecfg = dataclasses.replace(ecfg, decode_mode=decode_mode)  # one pool for both routes
    n_dev = mesh.dp
    N = len(requests)
    n_rows = n_dev * per_chip
    assert N <= n_rows, (
        f"{N} requests > {n_dev} devices x {per_chip} per chip "
        "(chunk the batch)"
    )
    pb = pad_batch(cfg, ecfg, requests, seeds=seeds, per_chip=per_chip, n_rows=n_rows)
    arrays = [pb[k] for k in ("text", "lang", "x_lens", "prompt_cb0", "prompt_codes",
                              "prompt_lens")]
    if per_chip > 1:
        fn = make_chunked_synthesis(
            model, cfg, ecfg, mesh,
            s_text=pb["s_text"], p_audio=pb["p_audio"], t_gen=pb["t_gen"],
            t_audio=pb["t_audio"], per_chip=per_chip,
        )
        codes, gen_lens = fn(*arrays, pb["caps"], pb["seeds"])
    else:
        fn = make_batched_synthesis(
            model, cfg, ecfg, mesh,
            s_text=pb["s_text"], p_audio=pb["p_audio"], t_audio=pb["t_audio"],
            decode_mode=decode_mode,
        )
        codes, gen_lens = fn(*arrays, pb["seeds"])
    out = []
    for i in range(N):
        tp = int(pb["prompt_lens"][i])
        out.append(codes[i, tp: tp + int(gen_lens[i])])
    return out
