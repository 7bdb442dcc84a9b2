"""halo2_regex_tpu_torch — the PyTorch + CUDA port of ``halo2_regex_tpu``.

The port runs the bit-sliced matcher (``BitplaneMatcher(model, columns=
"full" | "witness" | "match", input_layout="bl" | "tiled")``), the
table-driven matcher (``PallasMatcher``, split and monolithic, for large
DFAs and long inputs) and the portable scan (``BatchMatcher``, any model,
on the table scan kernel) on an NVIDIA H100 through hand-written CUDA
kernels (``csrc/``, built with nvcc at first use), and on the CPU through
the kernels' plain PyTorch versions when the caller passes ``device="cpu"``;
``extract_runs`` decodes the masked runs of a result where it lies.  The
corpus-scan entry point is the CLI (``python -m halo2_regex_tpu_torch
scan ...``) over ``ScanJob``, with ``best_matcher`` picking the backend
and ``tile_corpus`` packing the tiled input contract on the host.  The
prover's host layer takes any of their results, on the card or not:
``expand_witness`` (compact witness -> ``RegexResult``), the constraint
checker (``check_witness``, ``check_witness_batch``, ``verify``), the npz
artifact (``save_witness``, ``load_witness``), the prover hand-off dump
(``witness.handoff``) and ``gen_circom``.  ``DistributedMatcher`` and
``SeqShardedMatcher`` split a batch over a ``make_mesh`` grid of devices
by strings or by bytes.  It imports ``torch`` and numpy, never JAX: the
host layer it needs (regex compiler, models, oracle, witness tables and
checker) is carried here as jax-free copies, because
importing any submodule of the JAX package runs that package's
``__init__``, which loads JAX.

Quick start::

    from halo2_regex_tpu_torch import (BatchMatcher, BitplaneMatcher, PallasMatcher,
                                       extract_runs, pack_batch, tile_corpus, zoo)

    model = zoo.email_headers_model(max_chars_size=1024, headers=("from",))
    matcher = BitplaneMatcher(model)  # on the card; device="cpu" for the CPU
    res = matcher(chars, lengths)  # [B, 1024] uint8, [B] int32 -> RegexResult
    runs = extract_runs(res.all_substr_ids, res.masked_characters, max_len=32)
    res = PallasMatcher(model)(chars, lengths)  # the same RegexResult
    res = BatchMatcher(model)(*pack_batch([b"from:bob@x.yz\r\n"], 1024))  # likewise
    tl = BitplaneMatcher(model, columns="match", input_layout="tiled")
    verdicts = tl(tile_corpus(chars_np, tl.L_pad), lengths)  # host-pretiled
    w = BitplaneMatcher(model, columns="witness")(chars, lengths)
    ok = check_witness_batch(model.regex_defs, expand_witness(model, w, chars))
"""

import sys as _sys

# The compiler front-end recurses over deep alternation ASTs (98-way
# catch-all groups under +/? are standard in zk-email regexes).
if _sys.getrecursionlimit() < 20_000:
    _sys.setrecursionlimit(20_000)

from .compiler.circom import gen_circom
from .compiler.decomposed import DecomposedRegexConfig, RegexPartConfig, VrmError
from .compiler.dfa import regex_to_dfa
from .compiler.parser import RegexParseError, parse_regex
from .compiler.pipeline import compile_allstr_text, dfa_to_regex_def_text
from .models import zoo
from .models.compiled import CompiledRegexModel
from .models.defs import AllstrRegexDef, RegexDefs, SubstrRegexDef
from .ops import best_matcher
from .ops.bitplane import BitplaneMatcher, tile_corpus
from .ops.extract import extract_runs, runs_to_python
from .ops.pallas_scan import PallasMatcher
from .ops.scan_torch import BatchMatcher
from .ops.reference import extract_substrings, match_substrs
from .parallel.data_parallel import DistributedMatcher
from .parallel.mesh import make_mesh
from .parallel.seq_parallel import SeqShardedMatcher
from .utils.io import CorpusLoader, pack_batch
from .utils.jobs import ScanJob
from .utils.trace import Counters
from .witness.checker import check_witness, check_witness_batch, verify
from .witness.expand import expand_witness
from .witness.io import load_witness, save_witness
from .witness.result import RegexResult
from .witness.tables import build_all_tables

__version__ = "0.1.0"

__all__ = [
    "AllstrRegexDef",
    "BatchMatcher",
    "BitplaneMatcher",
    "CompiledRegexModel",
    "CorpusLoader",
    "Counters",
    "DecomposedRegexConfig",
    "DistributedMatcher",
    "PallasMatcher",
    "RegexDefs",
    "RegexParseError",
    "RegexPartConfig",
    "RegexResult",
    "ScanJob",
    "SeqShardedMatcher",
    "SubstrRegexDef",
    "VrmError",
    "best_matcher",
    "build_all_tables",
    "check_witness",
    "check_witness_batch",
    "compile_allstr_text",
    "dfa_to_regex_def_text",
    "expand_witness",
    "extract_runs",
    "extract_substrings",
    "gen_circom",
    "load_witness",
    "make_mesh",
    "match_substrs",
    "pack_batch",
    "parse_regex",
    "regex_to_dfa",
    "runs_to_python",
    "save_witness",
    "tile_corpus",
    "verify",
    "zoo",
]
