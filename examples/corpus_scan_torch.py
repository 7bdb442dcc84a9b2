"""Production-shaped example on the PyTorch port: stream an email corpus,
extract addresses.  The counterpart of examples/corpus_scan.py.

The serving flow: compile the `from:` header model once, stream a
newline-delimited corpus in fixed batches with a resumable checkpoint,
and pull matched addresses off the device as compact (offset, length,
id, bytes) records with ``extract_runs`` on the device: only matches
leave the card, not full [B, L] masks.  ``best_matcher`` takes the
bit-sliced ``BitplaneMatcher`` for this model.

Run:  python examples/corpus_scan_torch.py               # on the card
      python examples/corpus_scan_torch.py --device cpu  # plain versions
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.setrecursionlimit(100_000)

import numpy as np

from halo2_regex_tpu_torch.models import zoo
from halo2_regex_tpu_torch.ops import best_matcher
from halo2_regex_tpu_torch.ops.extract import extract_runs
from halo2_regex_tpu_torch.utils.jobs import ScanJob


def main(device: str = "cuda") -> int:
    model = zoo.email_headers_model(max_chars_size=128, headers=("from",))
    matcher, backend = best_matcher(model, device=device)  # raises without CUDA unless "cpu"
    print(f"backend: {backend}")

    # A little corpus: mail headers, one line per record (\r\n endings on
    # disk — the DFA needs them, hence keep_newline below).
    lines = [
        b"from:alice@gmail.com\r",
        b"date: Mon, 17 Aug 2026\r",
        b"from:bob@sub.domain-x.org\r",
        b"x-priority: 1\r",
        b"from:carol@x.yz\r",
    ] * 20
    found = []

    def on_batch(res, chars, lengths, n_valid):
        # extraction on the device: only matched runs come back
        out = extract_runs(
            res.all_substr_ids, res.masked_characters, max_runs=1, max_len=64
        )
        ok = res.match_ok[:n_valid].cpu().numpy()
        lens = out["lengths"][:n_valid, 0].cpu().numpy()
        payload = out["bytes"][:n_valid, 0].cpu().numpy()
        for i in np.nonzero(ok)[0]:
            found.append(bytes(payload[i][: lens[i]]))

    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "mail.txt")
        with open(corpus, "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
        job = ScanJob(
            matcher,
            [corpus],
            checkpoint_path=os.path.join(tmp, "job.json"),
            batch_size=32,
            on_batch=on_batch,
            keep_newline=True,
        )
        counters = job.run()
    print(counters.to_json())
    uniq = sorted(set(found))
    print(f"extracted {len(found)} addresses, {len(uniq)} unique: {uniq}")
    assert len(found) == 60, len(found)
    assert uniq == [b"alice@gmail.com", b"bob@sub.domain-x.org", b"carol@x.yz"]
    print("OK")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sys.exit(main(ap.parse_args().device))
