"""Golden-file ("datadriven") test runner (reference: datadriven/src/*, a
port of cockroachdb/datadriven — re-designed, not translated).

File format::

    # comment
    cmd key=val key=(v1,v2) positional
    optional input lines
    ----
    expected output

Cases are separated by blank lines.  `run_test(path, handler)` parses each
case, calls `handler(TestData) -> str`, and compares against the recorded
expectation; with rewrite=True (or env RAFT_TPU_REWRITE=1) it regenerates
the file from actual outputs instead (reference: datadriven.rs:151-172's
rewrite mode).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class CmdArg:
    """One `key`, `key=val`, or `key=(v1,v2,...)` argument
    (reference: datadriven/src/test_data.rs)."""

    key: str
    vals: List[str] = field(default_factory=list)

    @property
    def value(self) -> str:
        return self.vals[0]


@dataclass
class TestData:
    """One directive block (reference: datadriven/src/test_data.rs:95)."""

    __test__ = False  # not a pytest class despite the name

    pos: str = ""
    cmd: str = ""
    cmd_args: List[CmdArg] = field(default_factory=list)
    input: str = ""
    expected: str = ""
    # The verbatim directive line, kept so rewrite mode reproduces it
    # exactly (recovering it from a text scan mis-fires when a case has no
    # input lines and the scan window drifts into OUTPUT lines).
    directive_line: str = ""

    def arg(self, key: str) -> Optional[CmdArg]:
        for a in self.cmd_args:
            if a.key == key:
                return a
        return None

    def scan_args(self, key: str) -> List[str]:
        a = self.arg(key)
        return a.vals if a else []


def _parse_args(line: str) -> Tuple[str, List[CmdArg]]:
    """Parse `cmd k=v k=(a,b) flag` (reference: datadriven/src/line_sparser.rs)."""
    parts: List[str] = []
    buf = ""
    depth = 0
    for ch in line:
        if ch == "(":
            depth += 1
            buf += ch
        elif ch == ")":
            depth -= 1
            buf += ch
        elif ch.isspace() and depth == 0:
            if buf:
                parts.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        parts.append(buf)
    if not parts:
        raise ValueError(f"empty directive line: {line!r}")
    cmd = parts[0]
    args = []
    for p in parts[1:]:
        if "=" in p:
            key, val = p.split("=", 1)
            if val.startswith("(") and val.endswith(")"):
                vals = [v.strip() for v in val[1:-1].split(",") if v.strip()]
            else:
                vals = [val]
            args.append(CmdArg(key=key, vals=vals))
        else:
            args.append(CmdArg(key=p))
    return cmd, args


def parse_file(path: str) -> List[TestData]:
    cases: List[TestData] = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i].rstrip("\n")
        if not line.strip() or line.lstrip().startswith("#"):
            i += 1
            continue
        td = TestData(pos=f"{path}:{i + 1}")
        td.cmd, td.cmd_args = _parse_args(line.strip())
        td.directive_line = line.strip()
        i += 1
        # input lines until the ---- separator
        input_lines = []
        while i < n and lines[i].strip() != "----":
            input_lines.append(lines[i].rstrip("\n"))
            i += 1
        td.input = "\n".join(input_lines)
        if i >= n:
            raise ValueError(f"{td.pos}: missing ---- separator")
        i += 1  # skip ----
        expected_lines = []
        while i < n and lines[i].strip() != "":
            expected_lines.append(lines[i].rstrip("\n"))
            i += 1
        td.expected = "\n".join(expected_lines)
        cases.append(td)
    return cases


def _render(td: TestData, output: str) -> str:
    out = [td.directive_line or td.cmd]
    if td.input:
        out.append(td.input)
    out.append("----")
    if output:
        out.append(output.rstrip("\n"))
    return "\n".join(out)


def run_test(
    path: str,
    handler: Callable[[TestData], str],
    rewrite: Optional[bool] = None,
) -> None:
    """Run every case in `path` through `handler`, comparing (or rewriting)
    expectations (reference: datadriven/src/datadriven.rs:91-137)."""
    if rewrite is None:
        rewrite = os.environ.get("RAFT_TPU_REWRITE") == "1"

    cases = parse_file(path)
    outputs = []
    for td in cases:
        outputs.append(handler(td).rstrip("\n"))

    if rewrite:
        blocks = [_render(td, out) for td, out in zip(cases, outputs)]
        with open(path, "w") as f:
            f.write("\n\n".join(blocks) + "\n")
        return

    for td, out in zip(cases, outputs):
        assert out == td.expected, (
            f"{td.pos}: output mismatch for `{td.cmd}`\n"
            f"--- expected ---\n{td.expected}\n--- got ---\n{out}"
        )


def walk(dir: str, handler_for_file: Callable[[str], None]) -> None:
    """Run `handler_for_file` on every .txt under `dir`
    (reference: datadriven/src/lib.rs walk)."""
    for name in sorted(os.listdir(dir)):
        if name.endswith(".txt"):
            handler_for_file(os.path.join(dir, name))
