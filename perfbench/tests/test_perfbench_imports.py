"""What the benchmark may import: nothing whose top-level name is ``jax``
or ``mfcc_tpu`` anywhere (compared whole: ``mfcc_tpu_torch`` is the port),
nothing of the port in the reference, and neither torch nor the port in the
load generator's process.  And the frozen oracles against the port's own,
which this test (not the benchmark) may import."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent
FORBIDDEN = {"jax", "mfcc_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return sorted((HERE.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("ref"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not imported(path) & {"mfcc_tpu_torch", "jax", "mfcc_tpu"}


def _loaded(module: str) -> set:
    code = (f"import sys, {module}; print(' '.join(sorted({{m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_load_generator_process_loads_neither_torch_nor_the_port():
    assert not _loaded("perfbench.drivers.clients") & {
        "torch", "mfcc_tpu_torch", "jax", "mfcc_tpu"}


def test_reference_loads_nothing_of_the_port():
    assert not _loaded("perfbench.ref.torch_ref") & {
        "mfcc_tpu_torch", "jax", "mfcc_tpu"}


def test_harness_loads_no_jax():
    assert not _loaded("perfbench.run") & {"jax", "jaxlib", "flax",
                                            "mfcc_tpu"}


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    n = 512 + 170 * 12
    t = np.arange(n) / 16000
    sig = 9000 * np.sin(2 * np.pi * (200 + 3000 * t) * t) \
        + rng.integers(-1500, 1500, (2, n))
    return np.clip(sig, -32768, 32767).astype(np.int16)


def test_frozen_oracles_equal_the_ports(audio):
    from mfcc_tpu_torch.config import MFCCConfig as PortConfig
    from mfcc_tpu_torch.ref import float_ref as port_float
    from mfcc_tpu_torch.ref import int_ref as port_int
    from perfbench.ref import float_ref, int_ref
    from perfbench.ref.config import MFCCConfig
    for x in audio:
        np.testing.assert_array_equal(
            int_ref.mfcc_int(x.astype(np.int64), MFCCConfig()),
            port_int.mfcc_int(x.astype(np.int64), PortConfig()))
        np.testing.assert_array_equal(
            float_ref.mfcc_float(x, MFCCConfig()),
            port_float.mfcc_float(x, PortConfig()))


def test_frozen_tables_equal_the_ports():
    from mfcc_tpu_torch import tables as port
    from perfbench.ref import tables
    np.testing.assert_array_equal(tables.int_window_curve(512, 8),
                                  port.int_window_curve(512, 8))
    np.testing.assert_array_equal(
        tables.int_filterbank_matrix(16000, 512, 32, 30).astype(np.int64),
        port.int_filterbank_matrix(16000, 512, 32, 30).astype(np.int64))
    np.testing.assert_array_equal(tables.float_mel_matrix(16000, 512, 32),
                                  port.float_mel_matrix(16000, 512, 32))


def test_vectorised_reference_equals_the_frozen_oracles(audio):
    import torch
    from perfbench.ref import float_ref, int_ref, torch_ref
    from perfbench.ref.config import MFCCConfig
    cfg = MFCCConfig()
    x = torch.from_numpy(audio)
    got_int = torch_ref.mfcc_int(x, cfg).numpy()
    got_float = torch_ref.mfcc_float(x, cfg).numpy()
    for s in range(len(audio)):
        np.testing.assert_array_equal(
            got_int[s], int_ref.mfcc_int(audio[s].astype(np.int64), cfg))
        np.testing.assert_allclose(
            got_float[s], float_ref.mfcc_float(audio[s], cfg), atol=1e-9)
    # a stretch from the middle of a stream, emphasised from its sample
    # before, is that part of the whole stream's result
    k = 170 * 5
    np.testing.assert_array_equal(
        torch_ref.mfcc_int(x[:, k:], cfg, prev=x[:, k - 1]).numpy(),
        got_int[:, 5:])
    np.testing.assert_allclose(
        torch_ref.mfcc_float(x[:, k:], cfg, prev=x[:, k - 1]).numpy(),
        got_float[:, 5:], atol=1e-9)
