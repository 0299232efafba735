"""Command-line surface of the port (vallex_tpu/cli.py on PyTorch): synthesize,
long-text, make-prompt, list-presets, ui (the gradio web UI, when gradio is
installed) and serve.

Usage:
  python -m vallex_tpu_torch.cli synthesize "Hello world." --prompt paimon -o out.wav
  python -m vallex_tpu_torch.cli synthesize "Hi." --device cpu --random-weights \\
      --config tiny.json --top-k 1 -o out.wav
  python -m vallex_tpu_torch.cli long-text "Para one. Para two." --mode fixed-prompt
  python -m vallex_tpu_torch.cli make-prompt me clip.wav --transcript "Hello there."
  python -m vallex_tpu_torch.cli list-presets
  python -m vallex_tpu_torch.cli ui --port 7860
  python -m vallex_tpu_torch.cli serve --port 8000 --random-weights --quantize int8kv

Runs on the GPU (`--device cuda`, the default) or, with `--device cpu`, on
the CPU through the kernels' plain versions. Weights come from
`--checkpoints` (`vallex-jax.npz`, else the reference's
`vallex-checkpoint.pt`, converted; `vocos-jax.npz`, `encodec-jax.npz`), or
with `--random-weights` and no checkpoint there, from a random init.
"""

from __future__ import annotations

import argparse
import logging
import sys

def _load(args, **engine):
    """preload_models with the --config overrides (+ `engine` fields, and
    --quantize when given)."""
    import json

    from . import api
    from .config import EngineConfig, ModelConfig

    if getattr(args, "quantize", None) is not None:
        engine["quantize"] = args.quantize
    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
    engine = {k: tuple(v) if isinstance(v, list) else v
              for k, v in {**overrides.get("engine", {}), **engine}.items()}
    return api.preload_models(
        args.checkpoints, random_weights=args.random_weights,
        cfg=ModelConfig(**overrides.get("model", {})), ecfg=EngineConfig(**engine),
        device=args.device,
    )


def _write_wav(path: str, wave) -> None:
    from .utils.audio import save_wav

    save_wav(path, wave)
    print(f"wrote {path} ({len(wave) / 24000:.2f}s)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoints", default="./checkpoints")
    p.add_argument(
        "--random-weights", action="store_true",
        help="run with random weights (structure/benchmark mode)",
    )
    p.add_argument(
        "--config", default=None,
        help="JSON file with config overrides: "
             '{"model": {ModelConfig fields}, "engine": {EngineConfig '
             "fields}}",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda: the hand-written kernels on the GPU; cpu: their plain"
             " versions on the CPU",
    )


def _add_quantize(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--quantize", default=None, choices=["none", "int8", "w8a8", "int8kv"],
        help="serving quantization: bf16 (none), int8 weights (W8A16), int8"
             " weights and activations (w8a8), or int8 weights with an int8"
             " KV cache (int8kv); default: the --config's, else none",
    )


def main(argv=None) -> int:
    logging.basicConfig(
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s",
        level=logging.INFO,
    )
    parser = argparse.ArgumentParser(prog="vallex_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synthesize", help="text → wav")
    p.add_argument("text")
    p.add_argument("--prompt", default=None, help="preset/custom voice name")
    p.add_argument("--language", default="auto")
    p.add_argument("--accent", default="no-accent")
    p.add_argument("--best-of", type=int, default=1)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=-100)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default="out.wav")
    _add_common(p)
    _add_quantize(p)

    p = sub.add_parser("long-text", help="paragraph → wav, sentence by sentence")
    p.add_argument("text")
    p.add_argument("--prompt", default=None)
    p.add_argument("--language", default="auto")
    p.add_argument("--accent", default="no-accent")
    p.add_argument(
        "--mode", default="sliding-window",
        choices=["fixed-prompt", "sliding-window"],
    )
    p.add_argument("-o", "--output", default="out.wav")
    _add_common(p)
    _add_quantize(p)

    p = sub.add_parser("make-prompt", help="enrollment clip → .npz voice")
    p.add_argument("name")
    p.add_argument("audio", help="wav file, 3-10 s")
    p.add_argument("--transcript", default=None)
    p.add_argument("--out-dir", default="./customs")
    _add_common(p)

    sub.add_parser("list-presets", help="list bundled voice prompts")

    p = sub.add_parser("ui", help="launch the gradio web UI")
    p.add_argument("--port", type=int, default=7860)
    _add_common(p)

    p = sub.add_parser(
        "serve",
        help="HTTP synthesis server with dynamic micro-batching "
        "(POST /synthesize, POST /synthesize-long, GET /healthz, GET /presets)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--max-batch", type=int, default=None,
        help="requests coalesced into one batched decode; default 8 with"
        " int8kv, else 4 (the JAX package's choice)",
    )
    p.add_argument(
        "--max-wait-ms", type=float, default=30.0,
        help="how long a lone request waits for batch companions",
    )
    p.add_argument(
        "--max-rows", type=int, default=5,
        help="total decode rows (requests × best_of) per best_of>1 batched"
        " call; the default keeps best_of>=3 requests on the single-request path",
    )
    p.add_argument(
        "--warmup", action="store_true",
        help="run the serving shapes (single + batched decode) once before"
        " accepting traffic",
    )
    _add_common(p)
    _add_quantize(p)

    args = parser.parse_args(argv)

    if args.cmd == "list-presets":
        import os

        from .api import PROMPT_SEARCH_DIRS

        seen = set()
        for d in PROMPT_SEARCH_DIRS:
            if os.path.isdir(d):
                for f in sorted(os.listdir(d)):
                    if f.endswith(".npz") and f[:-4] not in seen:
                        seen.add(f[:-4])
                        print(f[:-4])
        return 0

    from . import api

    if args.cmd == "synthesize":
        _load(args)
        wave = api.generate_audio(
            args.text, prompt=args.prompt, language=args.language,
            accent=args.accent, best_of=args.best_of,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed,
        )
        _write_wav(args.output, wave)
        return 0

    if args.cmd == "long-text":
        _load(args)
        wave = api.generate_audio_from_long_text(
            args.text, prompt=args.prompt, language=args.language,
            accent=args.accent, mode=args.mode,
        )
        _write_wav(args.output, wave)
        return 0

    if args.cmd == "make-prompt":
        _load(args)
        out = api.make_prompt(args.name, args.audio, transcript=args.transcript,
                              out_dir=args.out_dir)
        print(f"wrote {out}")
        return 0

    if args.cmd == "ui":
        from .ui import launch_ui

        _load(args)
        launch_ui(port=args.port)
        return 0

    if args.cmd == "serve":
        from .server import serve_forever, warmup

        bundle = _load(args)
        max_batch = (args.max_batch if args.max_batch is not None
                     else api._long_text_batch_size(bundle.ecfg))
        if args.warmup:
            warmup(max_batch)
        serve_forever(
            args.host, args.port,
            max_batch=max_batch, max_wait_ms=args.max_wait_ms,
            max_rows=args.max_rows,
        )
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
