"""Side-by-side timing of the port's NAR and training step on one GPU.

Usage (one checkout per run; the card must be the same for all of them):
    python3 tools/torch_nar_train_ab.py ROOT

ROOT is a checkout of the repository (this one, or another commit unpacked
with `git archive`). The script imports `vallex_tpu_torch` and
`chip_smoke.py` from ROOT, builds its kernels, and prints one `AB` line:
the NAR seconds of four greedy batches of four requests (the batch of
`chip_smoke.py` phase 5b, C = 2304) and of four single requests with the
758-frame `fuxuan` prompt (phase 6), each read from the pipeline's
`seconds["nar"]`; then it runs phase 5f's training path (`train_path`:
s/step, audio frames/s and a profiled step's device time by kernel).
Compare two commits only within one machine session, in turns:
parent, change, change, parent. Random weights from seed 0; no JAX.
"""

from __future__ import annotations

import os
import sys
import time


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from vallex_tpu_torch import api

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the GPU")
    dev = torch.device("cuda")
    bundle = api.preload_models(random_weights=True, seed=0, device=dev)
    texts = ["Hello world.",
             "The quick brown fox jumps over the lazy dog. It was a bright cold day in April.",
             "Good morning.", "Speech synthesis turns written text into sound."]
    prompts = ["paimon", "fuxuan", None, "alan"]
    nar_batch, wall_batch, nar_one = [], [], []
    for _ in range(4):
        t0 = time.perf_counter()
        api.generate_audio_batch(texts, prompts, language="en", top_k=1)
        wall_batch.append(time.perf_counter() - t0)
        nar_batch.append(bundle.last.seconds["nar"])
    for _ in range(4):
        api.generate_audio(text="The quick brown fox jumps over the lazy dog.", prompt="fuxuan",
                           language="en", max_duration=4.0, seed=1)
        nar_one.append(bundle.last.seconds["nar"])
    print(f"AB {sys.argv[1]}: batch-of-4 greedy NAR s {[round(x, 4) for x in nar_batch]}"
          f" (wall {[round(x, 3) for x in wall_batch]}); phase-6 request NAR s"
          f" {[round(x, 4) for x in nar_one]}", flush=True)
    chip_smoke.train_path(dev, bundle.cfg)


if __name__ == "__main__":
    main()
