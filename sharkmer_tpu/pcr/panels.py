"""Panel loading: built-in panels, panel files, panel URLs.

Reference: /root/reference/src/pcr/preconfigured.rs. Panels are schema
v2 YAML (see schemas/panel/v2.json): name, schema_version,
panel_version, clade, maintainers, changelog, references, validation.
Unknown fields are rejected at both panel and primer level
(deny_unknown_fields). Gene names derive as
``{gene}[-{region}][_{index}]`` and are prefixed with the panel name
(or gene_prefix) in output files.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field

from .params import PCRParams

log = logging.getLogger("sharkmer")

MAX_PANEL_YAML_BYTES = 10 * 1024 * 1024

_PANEL_FIELDS = {
    "name", "schema_version", "panel_version", "description", "clade",
    "taxon_id", "gene_prefix", "status", "source_url", "license", "citation",
    "notes", "$schema", "maintainers", "changelog", "primers", "references",
    "validation",
}

_PANELS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "panels")

BUILTIN_PANEL_NAMES = [
    "angiospermae", "bacteria", "c_elegans", "cnidaria", "human",
    "hydrozoa", "insecta", "metazoa", "teleostei",
]


@dataclass
class PanelFile:
    name: str
    description: str = ""
    schema_version: str | None = None
    panel_version: str | None = None
    clade: str | None = None
    gene_prefix: str | None = None
    status: str | None = None
    primers: list[PCRParams] = field(default_factory=list)
    raw: dict = field(default_factory=dict)


# -- block-YAML reader -------------------------------------------------------
#
# Panel files use a small subset of YAML: block mappings and sequences
# (including sequences at their parent key's indent), single-line flow
# lists and mappings, plain / single-quoted / double-quoted scalars
# (quoted ones may span lines), folded and literal block scalars, and
# comments. The reader below handles exactly that subset, resolves
# plain scalars with YAML 1.1 rules for null, bool, int and float, and
# reads dates as strings. Anything outside the subset is an error.


class YamlSubsetError(ValueError):
    pass


_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
)
# a mapping key (double-quoted, single-quoted or plain) and its colon
_KEY_RE = re.compile(
    r""" ( "(?:[^"\\]|\\.)*" | '(?:[^']|'')*'
         | [^\s#'"\[\]{},&*!|>%@`-][^#]*? | -[^\s#][^#]*? )
         :(?:\s+|$) """,
    re.VERBOSE,
)


def _resolve_plain(text: str):
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(text: str) -> str:
    """Drop a trailing `` # comment`` outside quotes."""
    quote = None
    escaped = False
    for i, c in enumerate(text):
        if quote:
            if escaped:
                escaped = False
            elif c == "\\" and quote == '"':
                escaped = True
            elif c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " [{,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _unquote(text: str) -> str:
    """A complete quoted scalar (quotes included) on one logical line."""
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    body = text[1:-1]
    out = []
    i = 0
    simple = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r",
              "0": "\0", "/": "/", " ": " ", "b": "\b", "f": "\f"}
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in simple:
            out.append(simple[e])
            i += 2
        elif e in "xuU":
            width = {"x": 2, "u": 4, "U": 8}[e]
            out.append(chr(int(body[i + 2 : i + 2 + width], 16)))
            i += 2 + width
        else:
            raise YamlSubsetError(f"unsupported escape \\{e}")
    return "".join(out)


def _quoted_end(text: str, start: int) -> int:
    """Index just past the quoted scalar opening at ``start``, or -1."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == '"' and c == "\\":
            i += 2
            continue
        if c == q:
            if q == "'" and i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    return -1


_FLOW_PLAIN_RE = re.compile(r"[^,\[\]{}:]*(?::(?! |,|\]|}|$)[^,\[\]{}:]*)*")


def _parse_flow(text: str):
    """A single-line flow collection (``[...]`` or ``{...}``)."""

    def skip(i):
        while text[i] == " ":
            i += 1
        return i

    def items(i, close):
        """Entries up to ``close``; each is a value, or key: value in a
        mapping. Returns (entries, index past ``close``)."""
        out = []
        i = skip(i)
        while text[i] != close:
            entry, i = value(i)
            if close == "}":
                i = skip(i)
                if text[i] != ":":
                    raise YamlSubsetError(f"expected ':' in {text!r}")
                v, i = value(i + 1)
                entry = (entry, v)
            out.append(entry)
            i = skip(i)
            if text[i] == ",":
                i = skip(i + 1)
            elif text[i] != close:
                raise YamlSubsetError(f"expected ',' or {close!r} in {text!r}")
        return out, i + 1

    def value(i):
        i = skip(i)
        c = text[i]
        if c == "[":
            return items(i + 1, "]")
        if c == "{":
            entries, i = items(i + 1, "}")
            return dict(entries), i
        if c in "\"'":
            end = _quoted_end(text, i)
            if end < 0:
                raise YamlSubsetError(f"unterminated string in {text!r}")
            return _unquote(text[i:end]), end
        m = _FLOW_PLAIN_RE.match(text, i)
        return _resolve_plain(m.group(0).strip()), m.end()

    try:
        v, end = value(0)
    except IndexError:
        raise YamlSubsetError(f"unterminated flow collection {text!r}")
    if text[end:].strip():
        raise YamlSubsetError(f"trailing text after {text!r}")
    return v


class _Reader:
    def __init__(self, text: str):
        self.lines = [ln.rstrip() for ln in text.splitlines()]
        self.i = 0

    def skip(self) -> None:
        while self.i < len(self.lines):
            s = self.lines[self.i].lstrip(" ")
            if s and not s.startswith("#"):
                return
            self.i += 1

    def eof(self) -> bool:
        self.skip()
        return self.i >= len(self.lines)

    def indent(self) -> int:
        ln = self.lines[self.i]
        return len(ln) - len(ln.lstrip(" "))

    def fail(self, msg: str):
        raise YamlSubsetError(f"line {self.i + 1}: {msg}")

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def node(self, ind: int):
        text = self.lines[self.i][ind:]
        if text.startswith(("---", "...", "%", "&", "*", "!", "? ")):
            self.fail(f"unsupported YAML syntax {text[:20]!r}")
        if self._is_item(text):
            return self.seq(ind)
        if _KEY_RE.match(text):
            return self.mapping(ind)
        self.i += 1
        return self.scalar(_strip_comment(text), ind - 1)

    def seq(self, ind: int) -> list:
        out = []
        while not self.eof() and self.indent() == ind:
            text = self.lines[self.i][ind:]
            if not self._is_item(text):
                break
            rest = text[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                if self.eof() or self.indent() <= ind:
                    out.append(None)
                    continue
                out.append(self.node(self.indent()))
                continue
            item_ind = ind + 1 + len(rest) - len(body)
            self.lines[self.i] = " " * item_ind + body
            out.append(self.node(item_ind))
        if not self.eof() and self.indent() > ind:
            self.fail("bad indentation after a sequence item")
        return out

    def mapping(self, ind: int) -> dict:
        out = {}
        while not self.eof() and self.indent() == ind:
            text = self.lines[self.i][ind:]
            if self._is_item(text):
                break
            m = _KEY_RE.match(text)
            if not m:
                self.fail(f"expected 'key: value', got {text[:40]!r}")
            raw_key = m.group(1)
            key = (
                _unquote(raw_key) if raw_key[0] in "\"'"
                else _resolve_plain(raw_key.strip())
            )
            rest = _strip_comment(text[m.end():])
            self.i += 1
            if rest:
                out[key] = self.scalar(rest, ind)
                continue
            if self.eof():
                out[key] = None
            elif self.indent() > ind:
                out[key] = self.node(self.indent())
            elif self.indent() == ind and self._is_item(
                self.lines[self.i][ind:]
            ):
                out[key] = self.seq(ind)
            else:
                out[key] = None
        if not self.eof() and self.indent() > ind:
            self.fail("bad indentation")
        return out

    def scalar(self, text: str, parent: int):
        """A value that starts on the line just consumed; ``parent`` is
        the indent that continuation lines must exceed."""
        if text[0] in ">|":
            return self.block_scalar(text, parent)
        if text[0] in "[{":
            return _parse_flow(text)
        if text[0] in "\"'":
            return self.quoted(text)
        parts = [text]
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            s = ln.lstrip(" ")
            if not s or s.startswith("#") or len(ln) - len(s) <= parent:
                break
            parts.append(_strip_comment(s))
            self.i += 1
        return _resolve_plain(" ".join(parts))

    def quoted(self, text: str) -> str:
        end = _quoted_end(text, 0)
        lines = [text]
        while end < 0:
            if self.i >= len(self.lines):
                self.fail("unterminated quoted string")
            lines.append(self.lines[self.i].strip())
            self.i += 1
            # fold: line breaks become spaces, empty lines newlines
            folded, pending = lines[0], 0
            for ln in lines[1:]:
                if not ln:
                    pending += 1
                    continue
                folded += ("\n" * pending) if pending else " "
                folded += ln
                pending = 0
            text = folded
            end = _quoted_end(text, 0)
        if _strip_comment(text[end:]):
            self.fail(f"text after a quoted scalar: {text[end:]!r}")
        return _unquote(text[:end])

    def block_scalar(self, header: str, parent: int) -> str:
        m = re.fullmatch(r"([>|])([-+]?)", header)
        if not m:
            self.fail(f"unsupported block scalar header {header!r}")
        style, chomp = m.groups()
        body = []
        content = None
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            s = ln.lstrip(" ")
            ind = len(ln) - len(s)
            if s and ind <= parent:
                break
            if s and content is None:
                content = ind
            body.append(ln[content:] if s else "")
            self.i += 1
        while body and body[-1] == "" and chomp != "+":
            body.pop()
        n_trail = 0
        if chomp == "+":
            while body and body[-1] == "":
                body.pop()
                n_trail += 1
        if style == "|":
            text = "\n".join(body)
        else:
            text, prev_blank = "", True
            for ln in body:
                if not ln:
                    text += "\n"
                    prev_blank = True
                    continue
                if ln.startswith(" "):
                    self.fail("more-indented lines in a folded scalar")
                if not prev_blank and not text.endswith("\n"):
                    text += " "
                text += ln
                prev_blank = False
        if not body:
            return ""
        if chomp == "-":
            return text
        return text + "\n" * (1 + n_trail)


def load_yaml(text: str):
    """Parse the block-YAML subset described above."""
    r = _Reader(text)
    if r.eof():
        return None
    value = r.node(r.indent())
    if not r.eof():
        r.fail("unexpected text at the top level")
    return value


def parse_panel_yaml(yaml_str: str) -> PanelFile:
    try:
        d = load_yaml(yaml_str)
    except YamlSubsetError as e:
        raise ValueError(f"Failed to parse panel YAML: {e}") from e
    if not isinstance(d, dict):
        raise ValueError("Failed to parse panel YAML: not a mapping")
    unknown = set(d) - _PANEL_FIELDS
    if unknown:
        raise ValueError(f"Unknown panel field(s): {sorted(unknown)}")
    for required in ("name", "description", "primers"):
        if required not in d:
            raise ValueError(f"Panel YAML missing required field '{required}'")
    primers = [
        PCRParams.from_yaml_dict(p, context=f" in panel '{d['name']}'")
        for p in d["primers"]
    ]
    sv = d.get("schema_version")
    return PanelFile(
        name=str(d["name"]),
        description=str(d["description"]),
        schema_version=str(sv) if sv is not None else None,
        panel_version=(
            str(d["panel_version"]) if d.get("panel_version") is not None else None
        ),
        clade=d.get("clade"),
        gene_prefix=d.get("gene_prefix"),
        status=d.get("status"),
        primers=primers,
        raw=d,
    )


def derive_gene_name(gene: str, region: str | None, index: int | None) -> str:
    """{gene}[-{region}][_{index}] (preconfigured.rs:172-179)."""
    name = gene
    if region is not None:
        name = f"{gene}-{region}"
    if index is not None:
        name = f"{name}_{index}"
    return name


def validate_gene_chars(gene: str, has_region: bool) -> None:
    """preconfigured.rs:187-203."""
    if "_" in gene:
        raise ValueError(
            f"gene '{gene}' must not contain '_' (reserved as index "
            f"delimiter in output names)."
        )
    if has_region and "-" in gene:
        raise ValueError(
            f"gene '{gene}' must not contain '-' when a `region` is also "
            f"set, because the derived output name `{{gene}}-{{region}}` "
            f"would be ambiguous."
        )


def validate_region_chars(region: str) -> None:
    if "_" in region:
        raise ValueError(
            f"region '{region}' must not contain '_' (reserved as index "
            f"delimiter in output names)."
        )


def validate_primer_uniqueness(primers: list[PCRParams], panel_name: str) -> None:
    seen: dict[tuple, int] = {}
    for i, p in enumerate(primers):
        if p.gene is not None:
            key = (p.gene, p.region, p.index)
            if key in seen:
                raise ValueError(
                    f"Panel '{panel_name}': duplicate primer entries for "
                    f"(gene={key[0]!r}, region={key[1]!r}, index={key[2]!r}) "
                    f"at positions {seen[key]} and {i}. Add an `index:` "
                    f"field to distinguish them."
                )
            seen[key] = i


def resolve_primer_gene_names(primers: list[PCRParams], panel_name: str) -> None:
    for p in primers:
        if p.gene is not None:
            validate_gene_chars(p.gene, p.region is not None)
        if p.region is not None:
            validate_region_chars(p.region)
    validate_primer_uniqueness(primers, panel_name)
    for p in primers:
        if p.gene is not None:
            p.gene_name = derive_gene_name(p.gene, p.region, p.index)


def require_clade_for_v2(panel: PanelFile, source: str) -> None:
    if panel.schema_version == "2" and panel.clade is None:
        raise ValueError(
            f"Panel '{panel.name}' from {source} declares schema_version: "
            f'"2" but is missing the required `clade` field.'
        )


def log_panel_version(panel: PanelFile, source: str) -> None:
    if panel.status == "deprecated":
        log.warning(
            "Panel '%s' from %s has status 'deprecated'. Consider switching "
            "to a newer panel.", panel.name, source,
        )
    if panel.panel_version:
        log.info(
            "Loaded panel '%s' v%s from %s (%d primer pair(s))",
            panel.name, panel.panel_version, source, len(panel.primers),
        )
    else:
        log.warning(
            "Panel '%s' from %s has no `panel_version` field. Versioning is "
            "recommended for reproducibility.", panel.name, source,
        )


def filter_deprecated_primers(
    primers: list[PCRParams], panel_name: str
) -> list[PCRParams]:
    active = []
    for p in primers:
        if p.deprecated:
            msg = (
                f"Panel '{panel_name}': skipping deprecated primer "
                f"'{p.gene_name}'."
            )
            if p.deprecated_by:
                msg += f" Use '{p.deprecated_by}' instead."
            if p.deprecated_reason:
                msg += f" Reason: {p.deprecated_reason}"
            log.warning(msg)
        else:
            active.append(p)
    return active


def _finalize(panel: PanelFile, source: str) -> list[PCRParams]:
    log_panel_version(panel, source)
    require_clade_for_v2(panel, source)
    resolve_primer_gene_names(panel.primers, panel.name)
    prefix = panel.gene_prefix or panel.name
    for p in panel.primers:
        p.gene_name = f"{prefix}_{p.gene_name}"
    return filter_deprecated_primers(panel.primers, panel.name)


def is_url(source: str) -> bool:
    return source.startswith("http://") or source.startswith("https://")


def load_panel_file(path: str) -> list[PCRParams]:
    with open(path) as f:
        yaml_str = f.read()
    panel = parse_panel_yaml(yaml_str)
    return _finalize(panel, path)


def load_panel_url(url: str) -> list[PCRParams]:
    import urllib.request

    log.info("Downloading primer panel from %s", url)
    req = urllib.request.Request(url, headers={"User-Agent": "sharkmer-tpu"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        data = resp.read(MAX_PANEL_YAML_BYTES + 1)
    if len(data) > MAX_PANEL_YAML_BYTES:
        raise ValueError(
            f"Panel YAML at {url} exceeds maximum size of "
            f"{MAX_PANEL_YAML_BYTES} bytes"
        )
    panel = parse_panel_yaml(data.decode())
    return _finalize(panel, url)


def load_panel_source(source: str) -> list[PCRParams]:
    if is_url(source):
        return load_panel_url(source)
    return load_panel_file(source)


def _builtin_panel_path(name: str) -> str:
    return os.path.join(_PANELS_DIR, f"{name}.yaml")


def get_builtin_panels() -> list[PanelFile]:
    panels = []
    for name in BUILTIN_PANEL_NAMES:
        with open(_builtin_panel_path(name)) as f:
            panels.append(parse_panel_yaml(f.read()))
    panels.sort(key=lambda p: p.name)
    return panels


def get_panel(panel_name: str) -> list[PCRParams]:
    if panel_name not in BUILTIN_PANEL_NAMES:
        raise ValueError(
            f"Unknown panel '{panel_name}'. Available panels: "
            f"{', '.join(sorted(BUILTIN_PANEL_NAMES))}"
        )
    with open(_builtin_panel_path(panel_name)) as f:
        panel = parse_panel_yaml(f.read())
    return _finalize(panel, f"built-in panel '{panel_name}'")


def export_panel_yaml(panel_name: str) -> str:
    if panel_name not in BUILTIN_PANEL_NAMES:
        raise ValueError(
            f"Unknown panel '{panel_name}'. Available panels: "
            f"{', '.join(sorted(BUILTIN_PANEL_NAMES))}"
        )
    with open(_builtin_panel_path(panel_name)) as f:
        return f.read()


def print_pcr_panels() -> None:
    panels = get_builtin_panels()
    print("Available PCR panels (use --export-panel <name> for details):\n")
    for panel in panels:
        n = len(panel.primers)
        noun = "primer" if n == 1 else "primers"
        version = panel.panel_version or "unversioned"
        print(f"  {panel.name:<16} v{version:<8} {panel.description} ({n} {noun})")
