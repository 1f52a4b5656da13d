#!/usr/bin/env python3
"""Data parallelism across cards: ``chip_smoke.py``'s phase 12 with a card a
rank, for a machine with several H100s (``chip_smoke.py`` itself needs one).

    python3 tools/dp_cards.py [--world 4] [--batch 8]

It builds the kernels, writes phase 5's corpus, and runs:

* ``chip_smoke.dp_ranks_phase`` on WORLD NCCL ranks, one card each, on a
  copy of ``conf/diff.yml`` with ``batch_size: BATCH`` (the global batch;
  the ragged 5 is padded to a multiple of the ranks): each rank's step held
  to one process on ``cuda:0`` on the same global batch, weights and draws,
  with phase 12's bounds, floor and control, ``evaluate()`` of one cv
  batch, and both world sizes' ms a step (CUDA events);
* ``chip_smoke.dp_nccl_cli_phase`` with ``--nproc_per_node=WORLD``: one
  epoch of that yml, then ``--generate``.

It fails, as ``chip_smoke.py`` does, on any miss, and without WORLD cards.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=4, help="ranks, a card each")
    ap.add_argument("--batch", type=int, default=8, help="the global batch; the ranks divide it")
    a = ap.parse_args(argv)
    import torch

    if torch.cuda.device_count() < a.world:
        cs.fail(f"{a.world} ranks need {a.world} cards; this machine has "
                f"{torch.cuda.device_count()}")
    card = cs.card_line()
    print(f"card: {card} (x {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"NCCL {torch.cuda.nccl.version()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from prior_diffuse_tpu_torch.ops import build

    build.build()
    build.library()
    with tempfile.TemporaryDirectory(prefix="dp_cards_") as root:
        corpus = cs.write_train_corpus(root)
        with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
            text = f.read()
        if "batch_size: 6" not in text:
            cs.fail("conf/diff.yml has no 'batch_size: 6' line")
        conf = os.path.join(root, f"diff_batch{a.batch}.yml")
        with open(conf, "w") as f:
            f.write(text.replace("batch_size: 6", f"batch_size: {a.batch}"))
        t0 = time.perf_counter()
        cs.dp_ranks_phase(torch.device("cuda:0"), card, root, corpus, a.world, "nccl", conf)
        cs.dp_nccl_cli_phase(root, corpus, card, a.world, conf)
        print(f"{a.world} NCCL ranks: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
