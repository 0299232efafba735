"""Canned example rows + UI copy (port of vallex_tpu/examples.py; the
counterpart of the reference's examples.py / descriptions.py)."""

# (text, prompt, language, accent) rows for UIs and smoke tests
infer_from_prompt_examples = [
    (
        "Welcome back, it is great to hear your voice again.",
        "paimon", "English", "no-accent",
    ),
    ("今天天气真不错，我们一起出去走走吧。", "rosalia", "中文", "no-accent"),
    ("こんにちは、お元気ですか。", "yaesakura", "日本語", "no-accent"),
    (
        "This sentence mixes languages for accent control.",
        "babara", "English", "中文",
    ),
]

long_text_example = (
    "This is a longer paragraph used to demonstrate sentence-level "
    "synthesis. Each sentence is rendered separately and the audio is "
    "stitched together at the end. The sliding window mode occasionally "
    "reuses the previous sentence as the acoustic prompt, which keeps the "
    "voice consistent over very long passages."
)

top_md = """
# VALL-E X on PyTorch
Zero-shot multilingual text-to-speech (English / 中文 / 日本語) with 3–10 s
voice cloning, cross-lingual accent control and long-text synthesis —
running on PyTorch with hand-written CUDA kernels for the GPU.
"""

infer_from_audio_md = """
Clone a voice from an uploaded enrollment clip (3–10 s) and synthesize new
text with it. Provide a transcript or let ASR transcribe the clip.
"""

make_prompt_md = """
Build a reusable `.npz` voice prompt from an enrollment clip. Prompts made
here can be used by name in the other tabs and the Python API.
"""

infer_from_prompt_md = """
Synthesize with a saved voice prompt (41 preset voices ship with the
framework; your own prompts load by name from ./customs).
"""

long_text_md = """
Long-text synthesis: the text is split into sentences (NLTK / jieba /
punctuation rules per language) and rendered sentence by sentence with
prompt reuse ("fixed-prompt") or prompt sliding ("sliding-window").
"""
