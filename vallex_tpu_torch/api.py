"""Public synthesis API (port of vallex_tpu/api.py: preload_models,
generate_audio, generate_audio_batch, generate_audio_from_long_text,
stream_audio_from_long_text, make_prompt, continual, _prepare_text, the
prompt loaders and codes_to_wave).

Runs on `cuda` unless the caller passes `device="cpu"`; with no GPU and no
explicit CPU device it raises rather than falling back. Voice prompts use
the reference's `.npz` format (`audio_tokens` (1, T, 8), `text_tokens`
(1, S), `lang_code`), so the 41 shipped presets load unchanged.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .codec import encodec as EC
from .codec import vocos as VC
from .config import (
    ENCODEC_FRAME_RATE as FRAME_RATE,
    NUM_QUANTIZERS,
    SAMPLE_RATE,
    EngineConfig,
    ModelConfig,
    code2lang,
    lang2code,
    lang2token,
    langdropdown2token,
    model_language_id,
    token2lang,
)
from .convert import load_tree
from .engine.ar import bucket
from .engine.nar import nar_generate
from .engine.pipeline import (
    DTYPES,
    BatchSynthesisResult,
    PendingSynthesis,
    SynthesisPipeline,
    SynthesisResult,
)
from .frontend import PhonemeTokenizer, get_text_token_collater, split_text_into_sentences
from .frontend.langid import classify
from .models.vallex import VALLE, init_vallex
from .utils.device import resolve_device

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
    encodec: Optional[EC.EnCodec] = None  # make_prompt's codec


_bundle: Optional[ModelBundle] = None


def preload_models(
    checkpoint_dir: str = "./checkpoints",
    *,
    random_weights: bool = False,
    cfg: Optional[ModelConfig] = None,
    ecfg: Optional[EngineConfig] = None,
    seed: int = 0,
    device=None,
    params=None,
    vocos_params=None,
    encodec_params=None,
) -> ModelBundle:
    """Build the model stack on `device`.

    VALL-E weights, in the JAX package's order: `params` (a parameter tree
    in the JAX package's layout, numpy or torch leaves, e.g.
    `jax.tree.map(np.asarray, params)`) → `checkpoint_dir/vallex-jax.npz`
    → `checkpoint_dir/vallex-checkpoint.pt` (the reference's, converted,
    and the tree written beside it as `vallex-jax.npz`) → with
    random_weights=True a random init from torch.Generator(seed) → else
    FileNotFoundError. Vocos: `vocos_params` → `vocos-jax.npz` → random at
    seed + 1 when the VALL-E weights are random → none. EnCodec (for
    make_prompt): `encodec_params` → `encodec-jax.npz` → random at seed + 2
    when the VALL-E weights are random → none."""
    from .utils import checkpoint as CK

    global _bundle
    cfg = cfg or ModelConfig()
    ecfg = ecfg or EngineConfig()
    dev = resolve_device(device)

    def path(name: str) -> Optional[str]:
        p = os.path.join(checkpoint_dir, name)
        return p if os.path.exists(p) else None

    rand = False
    if params is not None:
        pass
    elif path("vallex-jax.npz"):
        params = CK.load_native(path("vallex-jax.npz"))
    elif path("vallex-checkpoint.pt"):
        logger.info("converting torch checkpoint %s", path("vallex-checkpoint.pt"))
        params = CK.load_torch_checkpoint(path("vallex-checkpoint.pt"), cfg)
        CK.save_native(os.path.join(checkpoint_dir, "vallex-jax.npz"), params)
    elif random_weights:
        logger.warning("no checkpoint found — using RANDOM weights")
        params = init_vallex(cfg, torch.Generator().manual_seed(seed))
        rand = True
    else:
        raise FileNotFoundError(
            f"No checkpoint in {checkpoint_dir}. Place the reference's "
            "vallex-checkpoint.pt there (see README) or pass "
            "random_weights=True for a structure-only run.")
    if vocos_params is None:
        if path("vocos-jax.npz"):
            vocos_params = CK.load_native(path("vocos-jax.npz"))
        elif rand:
            vocos_params = VC.init_vocos(torch.Generator().manual_seed(seed + 1))
    if encodec_params is None:
        if path("encodec-jax.npz"):
            encodec_params = CK.load_native(path("encodec-jax.npz"))
        elif rand:
            encodec_params = EC.init_encodec(torch.Generator().manual_seed(seed + 2))

    model = load_tree(VALLE(cfg), params, dtype=DTYPES[ecfg.compute_dtype], device=dev)
    vocos = (None if vocos_params is None
             else load_tree(VC.Vocos(), vocos_params, dtype=torch.float32, device=dev))
    _bundle = ModelBundle(
        model=model, cfg=cfg, ecfg=ecfg,
        pipeline=SynthesisPipeline(model, cfg, ecfg, vocos),
        vocos=vocos, device=dev,
        encodec=(None if encodec_params is None
                 else EC.encodec_from_tree(encodec_params, device=dev)),
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


def _synthesize_async(bundle: ModelBundle, sent: str, prompt: Prompt, language: str,
                      accent: str, *, best_of: Optional[int], seed: int,
                      return_wave: bool) -> PendingSynthesis:
    """Dispatch one sentence through the single-request pipeline and
    return its PendingSynthesis without waiting for the tail
    (vallex_tpu/api.py:316)."""
    audio, text_prompt, lang_pr = prompt
    text_ids, lang_ids = _prepare_text(bundle, sent, text_prompt, lang_pr, language, accent)
    return bundle.pipeline.synthesize_async(
        text_ids, lang_ids, audio if len(audio) else None, best_of=best_of, seed=seed,
        return_wave=return_wave and bundle.vocos is not None)


def _fetch(bundle: ModelBundle, handle: PendingSynthesis) -> SynthesisResult:
    res = handle.result()
    bundle.last = res
    return res


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


def _dispatch_sentences(bundle: ModelBundle, sentences: List[str], fixed: Prompt,
                        language: str, accent: str, mode: str, best_of: Optional[int],
                        seed: int, *, return_wave: bool) -> Iterator[PendingSynthesis]:
    """The sentence loop of both long-text entry points: dispatches each
    sentence (seed + i) and yields its handle at once. The sliding
    window's p = 0.5 coin is pre-drawn from np.random.RandomState(seed)
    per sentence in the JAX package's order (vallex_tpu/api.py:553-585).
    Below 0.5 the next prompt needs this sentence's codes, so its handle
    is fetched here before the next dispatch; otherwise the next sentence
    is dispatched while this one's tail may still run. The tokens are
    those of a loop that fetches each sentence before the next."""
    rng = np.random.RandomState(seed)
    cur = fixed
    for i, sent in enumerate(sentences):
        logger.info("synthesize sentence %d/%d", i + 1, len(sentences))
        h = _synthesize_async(bundle, sent, cur, language, accent, best_of=best_of,
                              seed=seed + i, return_wave=return_wave)
        coin = rng.rand() if mode == "sliding-window" else 1.0
        yield h
        if coin < 0.5:
            cur = _slid_prompt_triple(bundle, sent, h.result().codes, language)
        elif mode == "sliding-window":
            cur = fixed


def _batched_route(bundle: ModelBundle, sentences: List[str], mode: str,
                   best_of: Optional[int]) -> bool:
    """Fixed-prompt sentences on the kernel path go through the batched
    path (_fixed_prompt_batches), as in the JAX package."""
    return (mode == "fixed-prompt" and len(sentences) > 1
            and (best_of or bundle.ecfg.best_of) == 1
            and bundle.pipeline.decode_mode == "megakernel")


def _long_text_codes(bundle: ModelBundle, sentences: List[str], fixed: Prompt,
                     language: str, accent: str, mode: str, best_of: Optional[int],
                     seed: int) -> List[np.ndarray]:
    """Each sentence's codes through the double-buffered loop of the JAX
    package (vallex_tpu/api.py:553-585): sentence i + 1 is dispatched
    before sentence i is fetched, unless i's coin says its codes make the
    next prompt."""
    codes, pending = [], None
    for h in _dispatch_sentences(bundle, sentences, fixed, language, accent, mode, best_of,
                                 seed, return_wave=False):
        if pending is not None:
            codes.append(_fetch(bundle, pending).codes)
        pending = h
    if pending is not None:
        codes.append(_fetch(bundle, pending).codes)
    return codes


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
    Sentence i + 1's AR runs while sentence i's NAR runs on the pipeline's
    tail stream (_long_text_codes).
    → one waveform @ 24 kHz, vocoded over the concatenated codes."""
    bundle = _require_bundle()
    if prompt is None:
        mode = "sliding-window"
    sentences = split_text_into_sentences(text)
    fixed = _load_prompt(prompt)
    if _batched_route(bundle, sentences, mode, best_of):
        codes = [c for c, _ in _fixed_prompt_batches(bundle, sentences, fixed, language,
                                                     accent, seed=seed, return_wave=False,
                                                     first_alone=False)]
    else:
        codes = _long_text_codes(bundle, sentences, fixed, language, accent, mode, best_of,
                                 seed)
    return codes_to_wave(bundle, np.concatenate(codes, axis=0))


_DONE = object()


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """q.put that gives up once `stop` is set → whether the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            pass
    return False


def _overlapped_stream(bundle: ModelBundle, sentences: List[str], fixed: Prompt,
                       language: str, accent: str, mode: str, best_of: Optional[int],
                       seed: int) -> Iterator[np.ndarray]:
    """Each sentence's wave as soon as its tail is done, while the next
    sentence's AR runs. Sentence 0 is dispatched, fetched and handed out on
    the calling thread, as a loop of one sentence at a time would: until
    the first wave is out, no other thread shares the host. When the reader
    asks for the next wave, a worker thread runs the rest of
    _dispatch_sentences and hands the handles over a queue of one, and this
    generator fetches and yields. (The JAX order, dispatch i + 1 then fetch
    i, would hold each wave back by one AR here: the port's AR runs on the
    host, so dispatching a sentence means running its AR.) Closing the
    generator stops the worker after the sentence it is on and joins it."""
    handles = _dispatch_sentences(bundle, sentences, fixed, language, accent, mode, best_of,
                                  seed, return_wave=True)
    first = next(handles, None)
    if first is None:
        return
    q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()

    def work():
        try:
            for h in handles:
                if not _put(q, h, stop):
                    return
        except BaseException as exc:  # noqa: BLE001 (handed to the reader)
            _put(q, exc, stop)
        _put(q, _DONE, stop)

    def wave(res: SynthesisResult) -> np.ndarray:
        return res.wave if res.wave is not None else codes_to_wave(bundle, res.codes)

    yield wave(_fetch(bundle, first))
    worker = threading.Thread(target=work, name="vallex-long-text", daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield wave(_fetch(bundle, item))
    finally:
        stop.set()
        worker.join()


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
    sentence boundaries. Sentence i's wave comes while sentence i + 1's AR
    runs (_overlapped_stream); close the generator to stop early."""
    bundle = _require_bundle()
    if bundle.vocos is None:
        raise RuntimeError("streaming synthesis needs the Vocos vocoder weights")
    if prompt is None:
        mode = "sliding-window"
    sentences = split_text_into_sentences(text)
    fixed = _load_prompt(prompt)
    if _batched_route(bundle, sentences, mode, best_of):
        for codes, wave in _fixed_prompt_batches(bundle, sentences, fixed, language, accent,
                                                 seed=seed, return_wave=True,
                                                 first_alone=True):
            yield wave if wave is not None else codes_to_wave(bundle, codes)
        return
    yield from _overlapped_stream(bundle, sentences, fixed, language, accent, mode, best_of,
                                  seed)


# ---------------------------------------------------------------------------
# Prompt making and continuation (reference: utils/prompt_making.py,
# models/vallex.py:688-787)
# ---------------------------------------------------------------------------

def make_prompt(
    name: str,
    audio_prompt_path: str,
    transcript: Optional[str] = None,
    *,
    out_dir: str = "./customs",
) -> str:
    """Enrollment clip → `out_dir/name.npz` voice prompt (reference:
    prompt_making.py:57-84), in the JAX package's format: `audio_tokens`
    int64 [1, T, 8], `text_tokens` int64 [1, S], `lang_code` int32. EnCodec
    encodes on the bundle's device. Without a transcript, Whisper
    transcribes the clip (utils/whisper_transcribe.py), which needs local
    Whisper weights; without them it asks for `transcript=`."""
    bundle = _require_bundle()
    if bundle.encodec is None:
        raise RuntimeError(
            "EnCodec weights unavailable (convert encodec_24khz to "
            "checkpoints/encodec-jax.npz)")
    from .utils.audio import load_wav

    wav, _ = load_wav(audio_prompt_path, target_sr=SAMPLE_RATE)
    if len(wav) / SAMPLE_RATE > 15:
        raise ValueError("Prompt too long, expect length below 15 seconds")

    if transcript is None:
        from .utils.whisper_transcribe import transcribe

        transcript, lang = transcribe(audio_prompt_path, device=bundle.device)
        text = f"{lang2token[lang]}{transcript}{lang2token[lang]}"
    else:
        lang = classify(transcript)
        lang_token = lang2token[lang]
        text = lang_token + transcript.replace("\n", "") + lang_token

    codes = EC.encode(bundle.encodec, torch.from_numpy(wav[None]).to(bundle.device))
    phone_tokens, _ = bundle.tokenizer.tokenize(text=f"_{text}".strip())
    text_ids, _ = bundle.collater([phone_tokens])

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}.npz")
    np.savez(
        out,
        audio_tokens=codes.cpu().numpy().astype(np.int64),
        text_tokens=np.asarray(text_ids).astype(np.int64),
        lang_code=np.int32(lang2code[lang]),
    )
    return out


@torch.inference_mode()
def continual(
    text: str,
    audio_codes: np.ndarray,  # [T, 8] full EnCodec codes of the utterance
    language: str = "auto",
) -> np.ndarray:
    """Acoustic continuation: keep codebook 0, re-render codebooks 1..7 of
    the suffix conditioned on a prefix of min(T/2, 225) frames, without
    language embeddings (reference: models/vallex.py:688-787). The NAR's
    attention takes `engine.nar.flash_route`: the flash forward on the card,
    on the CPU from s_text + t_audio >= 1536.
    → codes [T − prefix, 8] int64 of the suffix."""
    bundle = _require_bundle()
    text_ids, _ = _prepare_text(bundle, text, np.zeros((0,), np.int32), None, language,
                                "no-accent")
    T = len(audio_codes)
    prefix_len = min(T // 2, 3 * FRAME_RATE)
    e, dev = bundle.ecfg, bundle.device
    s_text = bucket(len(text_ids), e.text_buckets)
    t_audio = bucket(T, e.audio_buckets)

    text_pad = torch.zeros((1, s_text), dtype=torch.int64)
    text_pad[0, : len(text_ids)] = torch.from_numpy(text_ids.astype(np.int64))
    codes_in = torch.zeros((1, t_audio, NUM_QUANTIZERS), dtype=torch.int64)
    codes_in[0, :T] = torch.from_numpy(np.asarray(audio_codes, np.int64))
    text_pad, codes_in = text_pad.to(dev), codes_in.to(dev)
    out = nar_generate(bundle.model, bundle.cfg, text_pad, torch.zeros_like(text_pad),
                       len(text_ids), codes_in, T, prefix_len,
                       dtype=bundle.pipeline.dtype, add_lang=False)
    return out[0, prefix_len:T].cpu().numpy()
