"""Panel loading tests (preconfigured.rs test suite parity)."""

import pytest

from sharkmer_tpu.pcr import panels as panels_mod
from sharkmer_tpu.pcr.panels import (
    derive_gene_name,
    get_builtin_panels,
    get_panel,
    is_url,
    load_panel_file,
    load_panel_source,
    parse_panel_yaml,
    require_clade_for_v2,
    resolve_primer_gene_names,
    validate_gene_chars,
    validate_region_chars,
)

FIXTURE = "tests/fixtures/test_panel.yaml"

EXPECTED_PANEL_SIZES = {
    "angiospermae": 10, "bacteria": 6, "c_elegans": 8, "cnidaria": 7,
    "human": 9, "hydrozoa": 4, "insecta": 21, "metazoa": 7, "teleostei": 5,
}


def test_is_url():
    assert is_url("https://example.com/panel.yaml")
    assert is_url("http://example.com/panel.yaml")
    assert not is_url("/path/to/panel.yaml")
    assert not is_url("panel.yaml")


def test_load_panel_file_from_fixture():
    params = load_panel_file(FIXTURE)
    assert len(params) == 1
    assert params[0].gene_name == "test_panel_18S"
    assert load_panel_source(FIXTURE)[0].gene_name == "test_panel_18S"


def test_builtin_panels_load_and_are_versioned():
    panels = get_builtin_panels()
    assert len(panels) == 9
    for panel in panels:
        assert panel.panel_version, f"Panel '{panel.name}' missing panel_version"
        if panel.schema_version == "2":
            assert panel.clade, f"Panel '{panel.name}' v2 missing clade"


def test_builtin_panel_primer_counts():
    for name, expected in EXPECTED_PANEL_SIZES.items():
        params = get_panel(name)
        assert len(params) == expected, name
        for p in params:
            assert p.gene_name.startswith(f"{name}_") or "_" in p.gene_name


def test_unknown_panel():
    with pytest.raises(ValueError, match="Unknown panel"):
        get_panel("nonexistent")


def test_v2_panel_missing_clade_rejected():
    yaml_str = """
name: no_clade_panel
schema_version: "2"
panel_version: "1.0.0"
description: "v2 panel without clade"
primers:
  - gene: "X"
    forward_seq: "AAAA"
    reverse_seq: "TTTT"
"""
    panel = parse_panel_yaml(yaml_str)
    resolve_primer_gene_names(panel.primers, panel.name)
    with pytest.raises(ValueError, match="clade"):
        require_clade_for_v2(panel, "test")


def test_deny_unknown_panel_field():
    yaml_str = """
name: typo_panel
versoin: 1.0.0
description: "typo"
primers:
  - gene: "X"
    forward_seq: "A"
    reverse_seq: "T"
"""
    with pytest.raises(ValueError, match="Unknown panel field"):
        parse_panel_yaml(yaml_str)


def test_deny_unknown_primer_field():
    yaml_str = """
name: typo_panel
panel_version: 1.0.0
description: "typo"
primers:
  - gene: "X"
    forward_seq: "A"
    reverse_seq: "T"
    forward_sqe: "oops"
"""
    with pytest.raises(ValueError, match="Unknown primer field"):
        parse_panel_yaml(yaml_str)


def test_derive_gene_name():
    assert derive_gene_name("CO1", None, None) == "CO1"
    assert derive_gene_name("18S", "V9", None) == "18S-V9"
    assert derive_gene_name("CO1", None, 2) == "CO1_2"
    assert derive_gene_name("18S", "V5-V7", 1) == "18S-V5-V7_1"


def test_validate_gene_chars():
    with pytest.raises(ValueError):
        validate_gene_chars("Cyt-b", True)
    validate_gene_chars("psbA-trnH", False)
    validate_gene_chars("trnL-F", False)
    with pytest.raises(ValueError):
        validate_gene_chars("18S_rRNA", False)
    validate_gene_chars("5.8S", False)


def test_validate_region_chars():
    with pytest.raises(ValueError):
        validate_region_chars("V5_V7")
    validate_region_chars("V5-V7")


def test_primer_uniqueness_conflict():
    yaml_str = """
name: dup_panel
panel_version: "1.0.0"
description: "duplicate primer test"
primers:
  - gene: "CO1"
    forward_seq: "AAAA"
    reverse_seq: "TTTT"
  - gene: "CO1"
    forward_seq: "CCCC"
    reverse_seq: "GGGG"
"""
    panel = parse_panel_yaml(yaml_str)
    with pytest.raises(ValueError, match="duplicate"):
        resolve_primer_gene_names(panel.primers, panel.name)


def test_deprecated_primers_filtered():
    yaml_str = """
name: dep_panel
panel_version: "1.0.0"
description: "deprecation"
primers:
  - gene: "A"
    forward_seq: "AAAA"
    reverse_seq: "TTTT"
    deprecated: true
    deprecated_by: "B"
  - gene: "B"
    forward_seq: "CCCC"
    reverse_seq: "GGGG"
"""
    panel = parse_panel_yaml(yaml_str)
    resolve_primer_gene_names(panel.primers, panel.name)
    active = panels_mod.filter_deprecated_primers(panel.primers, panel.name)
    assert [p.gene_name for p in active] == ["B"]


def test_export_panel_yaml_roundtrip():
    raw = panels_mod.export_panel_yaml("cnidaria")
    panel = parse_panel_yaml(raw)
    assert panel.name == "cnidaria"
    with pytest.raises(ValueError):
        panels_mod.export_panel_yaml("nope")


# -- the block-YAML subset reader and the stats.yaml emitter ----------------

def _dates_as_strings(x):
    import datetime

    if isinstance(x, dict):
        return {_dates_as_strings(k): _dates_as_strings(v)
                for k, v in x.items()}
    if isinstance(x, list):
        return [_dates_as_strings(v) for v in x]
    if isinstance(x, datetime.date):
        return x.isoformat()
    return x


@pytest.mark.parametrize(
    "path",
    [f"sharkmer_tpu/panels/{n}.yaml" for n in panels_mod.BUILTIN_PANEL_NAMES]
    + [FIXTURE],
)
def test_yaml_reader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    assert panels_mod.load_yaml(text) == _dates_as_strings(
        yaml.safe_load(text)
    )


def test_yaml_reader_rejects_syntax_outside_the_subset():
    for text in ("a: &x 1\nb: *x\n", "a: 1\n  b: 2\n", "- a\nb: 1\n",
                 "a: \"open\n", "a: [a: b]\n", "a: {x 1}\n"):
        with pytest.raises(ValueError):
            parse_panel_yaml(text)


def test_stats_yaml_round_trip():
    yaml = pytest.importorskip("yaml")
    from sharkmer_tpu.stats import dump_yaml

    d = {
        "sharkmer_version": "0.1.0",
        "command": "sharkmer 'a b' \"q\" x: y # not a comment",
        "kmer_length": 19, "n_multi_kmers": None, "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
        "pcr_results": [
            {"gene_name": "g1", "status": "success", "n_products": 2,
             "product_lengths": [580, 601]},
            {"gene_name": "g2", "status": "fail", "n_products": 0,
             "failure_reason": "no path: budget\nexhausted ✘"},
        ],
        "empty": [],
    }
    text = dump_yaml(d)
    assert yaml.safe_load(text) == d
    assert panels_mod.load_yaml(text) == d


def test_main_path_does_not_import_pyyaml(tmp_path):
    """The count + sPCR path runs with PyYAML unimportable."""
    import os
    import subprocess
    import sys

    from util import random_genome, reads_from_genome, write_fastq

    path = tmp_path / "r.fastq"
    write_fastq(path, reads_from_genome(random_genome(800), 300, 90))
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "from sharkmer_tpu.main import main\n"
        f"rc = main([{str(path)!r}, '-s', 'x', '-k', '19', '--chunks', '1',"
        f" '--pcr-panel', 'cnidaria', '-o', {str(tmp_path / 'o')!r}])\n"
        "assert 'yaml' not in [m for m in sys.modules if sys.modules[m]]\n"
        "sys.exit(rc)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "o" / "x.stats.yaml").exists()
