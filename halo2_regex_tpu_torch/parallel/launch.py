"""Multi-process corpus-scan launcher (the port of
``halo2_regex_tpu.parallel.launch``).

Run the same command in every process, one per device; ``torch.distributed``
joins them (gloo on the CPU, nccl on the card):

    python -m halo2_regex_tpu_torch.parallel.launch \\
        --model model.npz --corpus 'shard-*.txt' [--device cpu|cuda] \\
        [--coordinator host0:1234 --num-processes N --process-id i]

Each process loads its round-robin share of the corpus files
(``utils.io.CorpusLoader`` process sharding), runs its local batches
through the portable scan's ``_match_core`` on its own device (CUDA
device ``process_id % device_count``), and the four match-count statistics
are summed across processes with ``all_reduce``; process 0 prints them as
the JAX launcher does.  One process without ``--coordinator`` runs alone;
with one, it forms a group of one and its sums go through the collective.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time

STATS = ("n_matched", "bytes_scanned", "n_dead", "n_valid")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--corpus", nargs="+", required=True)
    ap.add_argument("--batch-per-host", type=int, default=1024)
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument(
        "--keep-newline",
        action="store_true",
        help="restore each line's \\n terminator (required for models "
        "whose accept state needs \\r\\n, e.g. the email headers)",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where each process runs its batches (cuda raises without CUDA)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.compiled import CompiledRegexModel
    from ..ops.bitplane import resolve_device
    from ..ops.scan_torch import _match_core, _model_arrays, arrays_on
    from ..utils.io import CorpusLoader
    from ..utils.jobs import _prefetched
    from .mesh import initialize_distributed

    rank = args.process_id or 0
    if args.device == "cuda":
        resolve_device("cuda")  # raises where CUDA is absent
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=args.device,
    )
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1

    model = CompiledRegexModel.load(args.model)
    arrays = arrays_on(_model_arrays(model), dev)
    n_defs = model.n_defs

    @torch.no_grad()
    def step(chars, lengths, valid):
        out = _match_core(arrays, n_defs, chars, lengths)
        # ``valid`` excludes batch-padding rows (and is the step-count
        # synchronization signal: its global sum is 0 exactly when every
        # process has exhausted its corpus shard)
        stats = torch.stack([
            (out["match_ok"] & valid).sum(),
            torch.where(valid, lengths, 0).sum(),
            (out["has_dead"].any(1) & valid).sum(),
            valid.sum(),
        ]).to(torch.int64)
        if grouped:
            dist.all_reduce(stats, op=dist.ReduceOp.SUM)
        return dict(zip(STATS, stats.tolist()))

    paths = sorted(p for pat in args.corpus for p in glob.glob(pat))
    loader = CorpusLoader(
        paths,
        max_len=model.max_chars_size,
        batch_size=args.batch_per_host,
        process_index=rank,
        process_count=world,
        keep_newline=args.keep_newline,
    )

    totals = {"n_matched": 0, "bytes_scanned": 0, "n_dead": 0, "strings": 0}
    t0 = time.time()
    # Every process must run the SAME number of global steps even when
    # shards are unevenly sized (different per-process batch counts would
    # deadlock the collectives): exhausted processes keep contributing
    # empty batches until the global valid-count hits 0.
    Bh = args.batch_per_host
    Lm = model.max_chars_size
    # overlap each process's read+pack with its device step
    it = _prefetched(iter(loader), 2)
    row = torch.arange(Bh, device=dev)
    while True:
        nxt = next(it, None)
        if nxt is None:
            chars = np.zeros((Bh, Lm), np.uint8)
            lengths = np.zeros((Bh,), np.int32)
            n_valid = 0
        else:
            chars, lengths, n_valid = nxt
        stats = step(torch.from_numpy(chars).to(dev), torch.from_numpy(lengths).to(dev),
                     row < n_valid)
        gv = stats["n_valid"]
        if gv == 0:
            break  # all processes exhausted (real batches have >=1 valid)
        totals["n_matched"] += stats["n_matched"]
        totals["bytes_scanned"] += stats["bytes_scanned"]
        totals["n_dead"] += stats["n_dead"]
        totals["strings"] += gv
    if rank == 0:
        dt = time.time() - t0
        totals["wall_seconds"] = round(dt, 3)
        totals["bytes_per_sec"] = round(totals["bytes_scanned"] / dt, 1) if dt else 0.0
        print(json.dumps(totals))
    if grouped:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
