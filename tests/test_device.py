"""Device table, backend checks, compile-cache placement, shard-count
validation, and the plain numpy reference of chip_smoke.py."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sharkmer_tpu import device

ROOT = Path(__file__).resolve().parent.parent


class FakeDevice:
    def __init__(self, kind, bytes_limit=None, platform="gpu"):
        self.device_kind = kind
        self.platform = platform
        self._limit = bytes_limit

    def memory_stats(self):
        return {"bytes_limit": self._limit}


def test_cpu_entry_keeps_test_sizes():
    import jax

    s = device.settings_for(jax.devices("cpu")[0])
    assert s.max_agg == 1 << 22
    assert s.spcr_index_rows == 1 << 27


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL",
])
def test_h100_entry_sized_from_bytes_limit(kind):
    # 75% of an 80 GB card, as a JAX process reserves by default
    s = device.settings_for(FakeDevice(kind, 60 * 10**9))
    assert s.max_agg == 1 << 27
    assert s.spcr_index_rows == 1 << 28
    # a process given a small share of the card gets smaller sizes
    small = device.settings_for(FakeDevice(kind, 4 * 10**9))
    assert small.max_agg == 1 << 24
    assert small.spcr_index_rows == 1 << 24


@pytest.mark.parametrize(
    "kind", ["NVIDIA H1000", "AMD Instinct MI300X", "Quantum"]
)
def test_unknown_device_kind_raises(kind):
    with pytest.raises(RuntimeError, match="no device settings"):
        device.settings_for(FakeDevice(kind, 60 * 10**9))


def test_backend_failure_raises(monkeypatch):
    import jax

    def broken(*_a, **_k):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        device.describe()
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        device.settings()


def test_describe_names_the_backend():
    d = device.describe()
    assert d == {"platform": "cpu", "kind": "cpu", "count": 8}


@pytest.mark.gpu
def test_device_table_on_card(gpu):
    s = device.settings_for(gpu)
    assert s.max_agg == 1 << 27
    assert s.spcr_index_rows >= 1 << 27


def _cache_dir(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import sharkmer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def test_compile_cache_defaults_inside_checkout():
    import sharkmer_tpu

    got = _cache_dir(None)
    assert got == str(ROOT / ".jax_cache") == sharkmer_tpu.CACHE_DIR


def test_compile_cache_honours_env(tmp_path):
    assert _cache_dir(str(tmp_path / "cc")) == str(tmp_path / "cc")


def test_n_shards_beyond_devices_raises():
    from sharkmer_tpu.engine import CountingEngine

    with pytest.raises(ValueError, match="16 shards requested but only 8"):
        CountingEngine(k=21, n_shards=16)


def test_cli_n_shards_beyond_devices_fails(tmp_path):
    from sharkmer_tpu.main import main

    from util import random_genome, reads_from_genome, write_fastq

    path = tmp_path / "r.fastq"
    write_fastq(path, reads_from_genome(random_genome(500), 50, 80))
    rc = main([str(path), "-s", "x", "-k", "17", "--chunks", "1",
               "--n-shards", "9", "-o", str(tmp_path / "out")])
    assert rc == 1
    assert not (tmp_path / "out" / "x.final.histo").exists()


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_smoke_numpy_reference_matches_counting(tmp_path):
    """chip_smoke's numpy reference (independent of sharkmer_tpu.ops)
    equals the CLI's chunk-prefix spectra on a small FASTQ with N bases
    and ragged read lengths."""
    from sharkmer_tpu.main import main

    from util import random_genome, reads_from_genome

    cs = _smoke()
    genome = random_genome(3000, seed=70, n_rate=0.01)
    reads = reads_from_genome(genome, 5200, 90, seed=71)
    reads = [r[: 60 + (i % 31)] for i, r in enumerate(reads)]
    path = tmp_path / "r.fastq.gz"
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    seqs = cs.read_fastq_seqs(path)
    assert [s.decode() for s in seqs] == reads
    spectra = cs.reference_spectra(seqs, 17, 3, 50, slab=700)
    rc = main([str(path), "-s", "x", "-k", "17", "--chunks", "3",
               "--histo-max", "50", "-o", str(tmp_path / "out")])
    assert rc == 0
    got = cs.read_histo(tmp_path / "out" / "x.histo")
    np.testing.assert_array_equal(got, spectra)
    # and the encoder agrees with the rolling reference read by read
    from sharkmer_tpu.ops.encoding import kmers_from_ascii_ref

    codes, _ = cs.encode_reads(seqs[:50])
    km, valid = cs.window_kmers(codes, 17)
    for i, r in enumerate(reads[:50]):
        assert km[i][valid[i]].tolist() == kmers_from_ascii_ref(r, 17)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
