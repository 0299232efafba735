"""Gradio web UI (port of vallex_tpu/ui.py; the counterpart of the
reference's launch-ui.py, 4 tabs).

gradio is an optional dependency; the CLI surfaces the same operations.
When gradio is available this module provides: infer-from-audio,
make-prompt, infer-from-prompt and long-text tabs, over the bundle that
`api.preload_models` built (on its device).
"""

from __future__ import annotations

import os
import tempfile
import time

from . import examples
from .config import SAMPLE_RATE


def launch_ui(port: int = 7860):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use `python -m vallex_tpu_torch.cli "
            "synthesize ...` for the same operations"
        ) from e

    from . import api

    presets = []
    for d in api.PROMPT_SEARCH_DIRS:
        if os.path.isdir(d):
            presets += [
                f[:-4] for f in sorted(os.listdir(d)) if f.endswith(".npz")
            ]
    presets = sorted(set(presets))

    # the reference UI decodes with best_of=5 beams in every infer tab
    # (launch-ui.py:295,355,446)
    UI_BEST_OF = 5

    # temp prompts made by "infer from audio" are GC'd once stale, like the
    # reference's clear_prompts (launch-ui.py:125-136)
    temp_prompts: list = []  # (path, created_at)

    def _gc_temp_prompts(max_age_s: float = 60.0):
        now = time.time()
        keep = []
        for path, created in temp_prompts:
            if now - created > max_age_s:
                try:
                    os.remove(path)
                except OSError:
                    pass
            else:
                keep.append((path, created))
        temp_prompts[:] = keep

    def infer_from_prompt(text, prompt, language, accent):
        wave = api.generate_audio(
            text, prompt=prompt or None,
            language="auto" if language == "auto-detect" else language,
            accent=accent, best_of=UI_BEST_OF,
        )
        return (SAMPLE_RATE, wave)

    def infer_from_audio(text, audio_path, transcript, language, accent):
        _gc_temp_prompts()
        tag = f"uiprompt{int(time.time())}"
        tmpdir = tempfile.mkdtemp()
        npz = api.make_prompt(
            tag, audio_path, transcript=transcript or None, out_dir=tmpdir
        )
        temp_prompts.append((npz, time.time()))
        wave = api.generate_audio(
            text, prompt=npz,
            language="auto" if language == "auto-detect" else language,
            accent=accent, best_of=UI_BEST_OF,
        )
        return (SAMPLE_RATE, wave)

    def make_npz(name, audio_path, transcript):
        out = api.make_prompt(
            name, audio_path, transcript=transcript or None
        )
        return out

    def long_text(text, prompt, mode):
        wave = api.generate_audio_from_long_text(
            text, prompt=prompt or None, mode=mode, best_of=UI_BEST_OF
        )
        return (SAMPLE_RATE, wave)

    langs = ["auto-detect", "en", "zh", "ja"]
    accents = ["no-accent", "English", "中文", "日本語"]

    with gr.Blocks() as app:
        gr.Markdown(examples.top_md)
        with gr.Tab("Infer from audio"):
            gr.Markdown(examples.infer_from_audio_md)
            t = gr.TextArea(label="Text")
            a = gr.Audio(label="Enrollment clip (3-10s)", type="filepath")
            tr = gr.TextArea(label="Transcript (optional)")
            l = gr.Dropdown(langs, value="auto-detect", label="language")  # noqa: E741
            ac = gr.Dropdown(accents, value="no-accent", label="accent")
            out = gr.Audio(label="Output")
            gr.Button("Generate").click(
                infer_from_audio, [t, a, tr, l, ac], [out]
            )
        with gr.Tab("Make prompt"):
            gr.Markdown(examples.make_prompt_md)
            n = gr.TextArea(label="Name")
            a2 = gr.Audio(label="Clip", type="filepath")
            tr2 = gr.TextArea(label="Transcript (optional)")
            f = gr.File(label="Prompt file")
            gr.Button("Make").click(make_npz, [n, a2, tr2], [f])
        with gr.Tab("Infer from prompt"):
            gr.Markdown(examples.infer_from_prompt_md)
            t3 = gr.TextArea(label="Text")
            pr = gr.Dropdown(presets, label="voice prompt")
            l3 = gr.Dropdown(langs, value="auto-detect", label="language")
            ac3 = gr.Dropdown(accents, value="no-accent", label="accent")
            out3 = gr.Audio(label="Output")
            gr.Button("Generate").click(
                infer_from_prompt, [t3, pr, l3, ac3], [out3]
            )
        with gr.Tab("Long text"):
            gr.Markdown(examples.long_text_md)
            t4 = gr.TextArea(label="Text", value=examples.long_text_example)
            pr4 = gr.Dropdown(presets, label="voice prompt")
            m4 = gr.Dropdown(
                ["fixed-prompt", "sliding-window"], value="fixed-prompt",
                label="mode",
            )
            out4 = gr.Audio(label="Output")
            gr.Button("Generate").click(long_text, [t4, pr4, m4], [out4])

    app.launch(server_port=port)
