"""The knob variants' plain stages against the JAX package's kernels on
the zk-email from: model (the tests of tests/test_torch_variants.py, run
here on their own so that each file's interpret-mode JAX work stays
short): the pack modes, also through the raw-quads and tiled packs, the
enable plane, B2's in-scan pack, B7 per def, B3's direct and witness
planes modes and B14.  Tolerance 0, dtypes included."""

from test_torch_variants import (  # noqa: F401  (the module-scoped fixtures)
    jax_variants, models, test_decode_plain_matches_jax, test_enable_plane_matches_jax,
    test_pack_modes_match_jax, test_post_direct_plain_matches_jax,
    test_post_planes_witness_plain_matches_jax, test_scan_def_plain_matches_jax,
    test_scan_fpack_plain_matches_jax)

STAGE_MODELS = ["from"]


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", STAGE_MODELS)
