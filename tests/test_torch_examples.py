"""The port's examples (``examples/*_torch.py``) against the JAX package's.

Each runs in process on the CPU (``device="cpu"``: the kernels' plain
versions) beside its JAX original: extract_email prints the same lines,
corpus_scan the same extraction line and "OK" (the JAX ladder takes its
portable scan on a CPU, the port its bit-sliced matcher, so the backend
and timing lines differ), prover_handoff writes the same file byte for
byte and prints the same verdict.  Their card runs are in
tests/test_torch_cuda.py.
"""

import pytest
import torch

import examples.corpus_scan as jax_corpus_scan
import examples.corpus_scan_torch as corpus_scan
import examples.extract_email as jax_extract_email
import examples.extract_email_torch as extract_email
import examples.prover_handoff as jax_prover_handoff
import examples.prover_handoff_torch as prover_handoff


def _run(capsys, main, *args):
    main(*args)
    return capsys.readouterr().out.splitlines()


def test_extract_email_prints_what_jax_prints(capsys):
    want = _run(capsys, jax_extract_email.main)
    got = _run(capsys, extract_email.main, "cpu")
    assert got == want == ["extracted: [(21, 'vitalik', 1)]", "witness verifies: True"]


def test_corpus_scan_extracts_what_jax_extracts(capsys):
    want = _run(capsys, jax_corpus_scan.main)
    got = _run(capsys, corpus_scan.main, "cpu")
    assert got[0] == "backend: bitplane" and want[0] == "backend: xla"
    assert got[-2:] == want[-2:]
    assert got[-2].startswith("extracted 60 addresses, 3 unique") and got[-1] == "OK"


def test_prover_handoff_writes_what_jax_writes(tmp_path, capsys):
    want = _run(capsys, jax_prover_handoff.main, str(tmp_path / "jax.txt"))
    got = _run(capsys, prover_handoff.main, str(tmp_path / "torch.txt"))
    assert (tmp_path / "torch.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert got[-1] == want[-1] == "hand-off verified: 10 sections, extracted b'123456'"
    assert prover_handoff.main() == 0  # no file


@pytest.mark.parametrize("main", [extract_email.main, corpus_scan.main])
def test_the_card_default_raises_without_cuda(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py runs the card default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()
