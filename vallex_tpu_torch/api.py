"""Public synthesis API (port of vallex_tpu/api.py: preload_models,
generate_audio, generate_audio_batch, generate_audio_from_long_text,
stream_audio_from_long_text, _prepare_text, the prompt loaders and
codes_to_wave).

Runs on `cuda` unless the caller passes `device="cpu"`; with no GPU and no
explicit CPU device it raises rather than falling back. Voice prompts use
the reference's `.npz` format (`audio_tokens` (1, T, 8), `text_tokens`
(1, S), `lang_code`), so the 41 shipped presets load unchanged.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .codec import vocos as VC
from .config import (
    ENCODEC_FRAME_RATE as FRAME_RATE,
    NUM_QUANTIZERS,
    EngineConfig,
    ModelConfig,
    code2lang,
    lang2token,
    langdropdown2token,
    model_language_id,
    token2lang,
)
from .convert import load_tree
from .engine.pipeline import (
    DTYPES,
    BatchSynthesisResult,
    SynthesisPipeline,
    SynthesisResult,
)
from .frontend import PhonemeTokenizer, get_text_token_collater, split_text_into_sentences
from .frontend.langid import classify
from .models.vallex import VALLE, init_vallex

logger = logging.getLogger(__name__)

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

# preset search paths, first hit wins (reference: generation.py:103-110)
PROMPT_SEARCH_DIRS = ["./presets", "./customs", os.path.join(_ASSET_DIR, "presets")]
if os.environ.get("VALLEX_PRESETS_DIR"):
    PROMPT_SEARCH_DIRS.insert(0, os.environ["VALLEX_PRESETS_DIR"])


@dataclass
class ModelBundle:
    model: VALLE
    cfg: ModelConfig
    ecfg: EngineConfig
    pipeline: SynthesisPipeline
    vocos: Optional[VC.Vocos]
    device: torch.device
    tokenizer: PhonemeTokenizer = field(default_factory=PhonemeTokenizer)
    collater: Any = field(default_factory=get_text_token_collater)
    # the latest synthesis (generate_audio or generate_audio_batch), with timings
    last: Optional[Union[SynthesisResult, BatchSynthesisResult]] = None


_bundle: Optional[ModelBundle] = None


def resolve_device(device=None) -> torch.device:
    """`cuda` unless told otherwise; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to"
            " run the plain PyTorch path on the CPU")
    return dev


def preload_models(
    checkpoint_dir: Optional[str] = None,
    *,
    random_weights: bool = False,
    cfg: Optional[ModelConfig] = None,
    ecfg: Optional[EngineConfig] = None,
    seed: int = 0,
    device=None,
    params=None,
    vocos_params=None,
) -> ModelBundle:
    """Build the model stack on `device`.

    Weights: `params` / `vocos_params` — parameter trees in the JAX
    package's layout (numpy or torch leaves, e.g. from
    `jax.tree.map(np.asarray, params)`) — or, with random_weights=True, a
    random init drawn from torch.Generator(seed) (Vocos from seed + 1).
    Reading checkpoint files is not ported yet (ROADMAP.md §1 item 4)."""
    global _bundle
    cfg = cfg or ModelConfig()
    ecfg = ecfg or EngineConfig()
    dev = resolve_device(device)
    if params is None:
        if not random_weights:
            raise NotImplementedError(
                f"loading checkpoints (from {checkpoint_dir!r}) is not ported"
                " yet (ROADMAP.md §1 item 4, slice 6); pass random_weights=True"
                " or params=<tree>")
        params = init_vallex(cfg, torch.Generator().manual_seed(seed))
        vocos_params = VC.init_vocos(torch.Generator().manual_seed(seed + 1))
    model = load_tree(VALLE(cfg), params, dtype=DTYPES[ecfg.compute_dtype], device=dev)
    vocos = (None if vocos_params is None
             else load_tree(VC.Vocos(), vocos_params, dtype=torch.float32, device=dev))
    _bundle = ModelBundle(
        model=model, cfg=cfg, ecfg=ecfg,
        pipeline=SynthesisPipeline(model, cfg, ecfg, vocos),
        vocos=vocos, device=dev,
    )
    return _bundle


def _require_bundle() -> ModelBundle:
    if _bundle is None:
        raise RuntimeError("call preload_models() first")
    return _bundle


def _find_prompt(prompt: str) -> str:
    if os.path.exists(prompt):
        return prompt
    for d in PROMPT_SEARCH_DIRS:
        p = os.path.join(d, prompt + ".npz")
        if os.path.exists(p):
            return p
    raise ValueError(f"Cannot find prompt {prompt}")


@functools.lru_cache(maxsize=256)
def _read_prompt_npz(path: str, mtime: float):
    """Disk read + parse, cached by (path, mtime)."""
    data = np.load(path)
    audio = np.asarray(data["audio_tokens"], np.int32).reshape(-1, NUM_QUANTIZERS)
    text = np.asarray(data["text_tokens"], np.int32).reshape(-1)
    lang_pr = code2lang[int(data["lang_code"])]
    audio.setflags(write=False)
    text.setflags(write=False)
    return audio, text, lang_pr


def _load_prompt(prompt: Optional[str]):
    """→ (audio_tokens [T, 8] int32, text_tokens [S] int32, lang code)."""
    if prompt is None:
        return (np.zeros((0, NUM_QUANTIZERS), np.int32), np.zeros((0,), np.int32), None)
    path = _find_prompt(prompt)
    return _read_prompt_npz(path, os.path.getmtime(path))


def _prepare_text(bundle: ModelBundle, text: str, text_prompt: np.ndarray,
                  lang_pr: Optional[str], language: str = "auto",
                  accent: str = "no-accent"):
    """Text + prompt text → (text_ids [S], per-position lang_ids [S])
    following the reference prologue (generation.py:96-138)."""
    text = text.replace("\n", "").strip(" ")
    if language == "auto":
        language = classify(text)
    lang_token = lang2token[language]
    lang = token2lang[lang_token]
    text = lang_token + text + lang_token
    if lang_pr is None:
        lang_pr = lang if lang != "mix" else "en"

    phone_tokens, langs = bundle.tokenizer.tokenize(text=f"_{text}".strip())
    text_ids, _ = bundle.collater([phone_tokens])
    text_ids = np.concatenate([text_prompt[None], text_ids], axis=1)[0]
    enroll = len(text_prompt)
    if accent == "no-accent":
        text_langs = [model_language_id[l] for l in langs]
    else:
        accent_lang = token2lang[langdropdown2token[accent]]
        text_langs = [model_language_id[accent_lang]] * len(langs)
    lang_ids = np.concatenate([
        np.full(enroll, model_language_id[lang_pr], np.int32),
        np.asarray(text_langs, np.int32),
    ])
    return text_ids.astype(np.int32), lang_ids


@torch.inference_mode()
def codes_to_wave(bundle: ModelBundle, codes: np.ndarray) -> np.ndarray:
    """[T, 8] codes → waveform [T · 320] via Vocos."""
    if bundle.vocos is None:
        raise RuntimeError("Vocos weights unavailable")
    c = torch.as_tensor(np.asarray(codes), device=bundle.device).long()[None]
    wave = VC.vocos_decode(bundle.vocos, c, bandwidth_id=2, t_len=c.shape[1])
    return wave[0].cpu().numpy()


def generate_audio(
    text: str,
    prompt: Optional[str] = None,
    language: str = "auto",
    accent: str = "no-accent",
    *,
    best_of: Optional[int] = None,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    seed: int = 0,
    max_duration: Optional[float] = None,
) -> np.ndarray:
    """Synthesize one utterance → float waveform @ 24 kHz (reference:
    generation.py:91-152). max_duration (seconds) caps the generated
    length. The result with its phase timings stays on bundle.last."""
    bundle = _require_bundle()
    audio_prompt, text_prompt, lang_pr = _load_prompt(prompt)
    text_ids, lang_ids = _prepare_text(bundle, text, text_prompt, lang_pr, language, accent)
    res = bundle.pipeline.synthesize(
        text_ids, lang_ids, audio_prompt if len(audio_prompt) else None,
        best_of=best_of, temperature=temperature, top_k=top_k, top_p=top_p,
        seed=seed, return_wave=bundle.vocos is not None,
        max_gen_frames=(None if max_duration is None
                        else max(1, int(max_duration * FRAME_RATE))),
    )
    bundle.last = res
    if res.wave is None:
        return codes_to_wave(bundle, res.codes)
    return res.wave


def generate_audio_batch(
    texts: List[str],
    prompts: Optional[List[Optional[str]]] = None,
    language: str = "auto",
    accent: str = "no-accent",
    *,
    best_of: Optional[int] = None,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Synthesize several independent utterances in one batched pass on one
    device: every AR decode step streams the weights once for all of them
    (engine/ar.py::ar_generate_batch), then the NAR and Vocos run batched.
    Requests may use different texts and voice prompts; language, accent
    and the sampling settings apply to the whole batch. → list of float
    waveforms @ 24 kHz, one per text. The result with its phase timings
    stays on bundle.last."""
    bundle = _require_bundle()
    if not texts:
        return []
    if prompts is None:
        prompts = [None] * len(texts)
    if len(prompts) != len(texts):
        raise ValueError("prompts must match texts (or be None)")
    requests = []
    for text, prompt in zip(texts, prompts):
        audio_prompt, text_prompt, lang_pr = _load_prompt(prompt)
        text_ids, lang_ids = _prepare_text(bundle, text, text_prompt, lang_pr, language, accent)
        requests.append((text_ids, lang_ids, audio_prompt if len(audio_prompt) else None))
    res = bundle.pipeline.synthesize_batch(
        requests, best_of=best_of or bundle.ecfg.best_of, temperature=temperature,
        top_k=top_k, top_p=top_p, seed=seed, return_wave=bundle.vocos is not None)
    bundle.last = res
    return [wave if wave is not None else codes_to_wave(bundle, codes)
            for codes, wave in res.outputs]


Prompt = Tuple[np.ndarray, np.ndarray, Optional[str]]  # (audio [T, 8], text ids, lang)


def _slid_prompt_triple(bundle: ModelBundle, sent: str, codes: np.ndarray,
                        language: str) -> Prompt:
    """Sliding-window prompt after one sentence (reference:
    generation.py:264-269, the p < 0.5 branch): this sentence's text and
    its last <= 225 generated frames. "mix" is a span marker, not a prompt
    language: the prompt language falls back to "en"."""
    lang = classify(sent) if language == "auto" else language
    lang_token = lang2token[lang]
    s_text = lang_token + sent.replace("\n", "").strip(" ") + lang_token
    phone_tokens, _ = bundle.tokenizer.tokenize(f"_{s_text}".strip())
    return (codes[-225:] if len(codes) > 225 else codes,
            np.asarray(phone_tokens, np.int32), lang if lang != "mix" else "en")


def _long_text_batch_size(ecfg: EngineConfig) -> int:
    """Sentence-batch size of fixed-prompt long text: 8 with the int8 KV
    cache, else 4 — the JAX package's choice, measured there on a TPU, not
    on the GPU (PERF.md, open questions)."""
    return 8 if ecfg.quantize == "int8kv" else 4


def _synthesize_sentence(bundle: ModelBundle, sent: str, prompt: Prompt, language: str,
                         accent: str, *, best_of: Optional[int], seed: int,
                         return_wave: bool):
    """One sentence through the single-request pipeline → (codes, wave)."""
    audio, text_prompt, lang_pr = prompt
    text_ids, lang_ids = _prepare_text(bundle, sent, text_prompt, lang_pr, language, accent)
    res = bundle.pipeline.synthesize(
        text_ids, lang_ids, audio if len(audio) else None, best_of=best_of, seed=seed,
        return_wave=return_wave and bundle.vocos is not None)
    bundle.last = res
    return res.codes, res.wave


def _fixed_prompt_batches(bundle: ModelBundle, sentences: List[str], prompt: Prompt,
                          language: str, accent: str, *, seed: int,
                          return_wave: bool, first_alone: bool):
    """Fixed-prompt sentences through the batched path, in chunks of
    _long_text_batch_size (vallex_tpu/api.py:518-548, :647-686); with
    first_alone the first sentence runs by itself, so a stream's first
    audio waits for one sentence only. Yields (codes, wave) per sentence."""
    audio, text_prompt, lang_pr = prompt
    requests = []
    for sent in sentences:
        text_ids, lang_ids = _prepare_text(bundle, sent, text_prompt, lang_pr, language, accent)
        requests.append((text_ids, lang_ids, audio if len(audio) else None))
    chunks, off = [], 0
    if first_alone:
        chunks, off = [(0, requests[:1])], 1
    B = _long_text_batch_size(bundle.ecfg)
    chunks += [(off + i, requests[off + i: off + i + B])
               for i in range(0, len(requests) - off, B)]
    for i, chunk in chunks:
        if len(chunk) == 1:
            t, lg, p = chunk[0]
            res = bundle.pipeline.synthesize(t, lg, p, best_of=1, seed=seed + i,
                                             return_wave=return_wave)
            bundle.last = res
            yield res.codes, res.wave
        else:
            res = bundle.pipeline.synthesize_batch(chunk, seed=seed + i,
                                                   return_wave=return_wave)
            bundle.last = res
            yield from res.outputs


def _long_text(text: str, prompt: Optional[str], language: str, accent: str, mode: str,
               best_of: Optional[int], seed: int, *, stream: bool):
    """The sentence loop shared by both long-text entry points: yields
    (codes, wave) per sentence. Fixed-prompt sentences on the kernel path
    go through the batched path; otherwise one sentence after the other,
    with the sliding window's p = 0.5 coin pre-drawn from
    np.random.RandomState(seed) as in the JAX package, so the prompts (and
    the token streams) follow the same draws. The JAX package overlaps
    sentence i + 1's dispatch with sentence i's fetch; this loop runs them
    in turn, which gives the same tokens."""
    bundle = _require_bundle()
    if prompt is None:
        mode = "sliding-window"
    sentences = split_text_into_sentences(text)
    fixed = _load_prompt(prompt)
    if (mode == "fixed-prompt" and len(sentences) > 1
            and (best_of or bundle.ecfg.best_of) == 1
            and bundle.pipeline.decode_mode == "megakernel"):
        yield from _fixed_prompt_batches(bundle, sentences, fixed, language, accent,
                                         seed=seed, return_wave=stream,
                                         first_alone=stream)
        return
    rng = np.random.RandomState(seed)
    cur = fixed
    for i, sent in enumerate(sentences):
        logger.info("synthesize sentence %d/%d", i + 1, len(sentences))
        codes, wave = _synthesize_sentence(bundle, sent, cur, language, accent,
                                           best_of=best_of, seed=seed + i,
                                           return_wave=stream)
        coin = rng.rand() if mode == "sliding-window" else 1.0
        yield codes, wave
        if coin < 0.5:
            cur = _slid_prompt_triple(bundle, sent, codes, language)
        elif mode == "sliding-window":
            cur = fixed


def generate_audio_from_long_text(
    text: str,
    prompt: Optional[str] = None,
    language: str = "auto",
    accent: str = "no-accent",
    mode: str = "sliding-window",
    *,
    best_of: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Long-text synthesis by sentence (reference: generation.py:154-276).

    mode='fixed-prompt': every sentence reuses the original prompt.
    mode='sliding-window': with p = 0.5 per sentence, the prompt is replaced
    by the previous sentence's generated codes + text
    (generation.py:264-269). The sampling settings are the EngineConfig's.
    → one waveform @ 24 kHz, vocoded over the concatenated codes."""
    codes = [c for c, _ in _long_text(text, prompt, language, accent, mode, best_of,
                                      seed, stream=False)]
    return codes_to_wave(_require_bundle(), np.concatenate(codes, axis=0))


def stream_audio_from_long_text(
    text: str,
    prompt: Optional[str] = None,
    language: str = "auto",
    accent: str = "no-accent",
    mode: str = "sliding-window",
    *,
    best_of: Optional[int] = None,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Long-text synthesis as a generator: yields each sentence's waveform
    as soon as it is ready, so the first audio waits for one sentence.
    Token streams equal generate_audio_from_long_text's under the same seed
    and mode (greedy always; sampled ones also in sliding-window mode — the
    fixed-prompt batches are cut differently); only the vocoder runs per
    sentence, so waveforms can differ within its receptive field at
    sentence boundaries."""
    bundle = _require_bundle()
    if bundle.vocos is None:
        raise RuntimeError("streaming synthesis needs the Vocos vocoder weights")
    for codes, wave in _long_text(text, prompt, language, accent, mode, best_of, seed,
                                  stream=True):
        yield wave if wave is not None else codes_to_wave(bundle, codes)
