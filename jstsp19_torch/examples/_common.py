"""What the worked examples share: the device a ``main`` runs on, the lines
it prints, and the numbers on those lines by label.

An example computes its printout as a list of ``(format, args)`` pairs, one
per ``print`` of the JAX script, with the script's format strings.
:func:`printed` gives the text; :func:`labelled` gives every number on it,
unrounded, under a label made from the line's position and its text with
the numbers taken out, so that the port's numbers and the ones parsed from
the JAX script's stdout (:func:`parse`) meet under the same labels.
"""
from __future__ import annotations

import math
import re
import string
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# a number not glued to a word ("t2", "x64" stay text), nan/inf, a bool
NUMBER = re.compile(r"(?<![A-Za-z_\d.])(?:[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?(?:nan|inf)\b|True\b|False\b)")

Lines = List[Tuple[str, tuple]]


def device_from_argv(argv: Sequence[str]):
    """The CPU with ``--cpu``, else the card; None (and a message naming
    CUDA) where there is no card."""
    if "--cpu" in argv:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    print("no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
    return None


def generator(seed: int) -> torch.Generator:
    """The CPU generator an example draws from (a card run gets the CPU's
    draws, moved)."""
    return torch.Generator().manual_seed(seed)


def main(build, lines, seed: int, argv=None) -> int:
    """Run an example: draw with ``build`` on the device ``argv`` names,
    compute its ``lines`` and print them."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = device_from_argv(argv)
    if device is None:
        return 1
    for line in printed(lines(build(device, generator(seed)))):
        print(line)
    return 0


class _Full(string.Formatter):
    """Formats every float unrounded (``repr``), whatever its format spec;
    the rest as ``format`` does."""

    def format_field(self, v, spec):
        if isinstance(v, (bool, np.bool_)):
            return str(bool(v))
        if isinstance(v, (float, np.floating)):
            return repr(float(v) * 100) + "%" if spec.endswith("%") else repr(float(v))
        if isinstance(v, np.ndarray):
            return np.array2string(v.astype(np.float64), max_line_width=10**6, floatmode="unique")
        return super().format_field(v, spec)


def _scalar(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    return v


def printed(lines: Lines) -> List[str]:
    """The lines as the JAX script prints them."""
    out = []
    for fmt, args in lines:
        out.extend(fmt.format(*(_scalar(a) for a in args)).split("\n"))
    return out


def template(line: str) -> str:
    """A line with its numbers replaced by ``#`` and its spacing normalized."""
    t = NUMBER.sub(" # ", line).replace("[", " [ ").replace("]", " ] ")
    return " ".join(t.split())


def _value(tok: str) -> float:
    return 1.0 if tok == "True" else 0.0 if tok == "False" else float(tok)


def tokens(text_lines: Sequence[str]) -> Dict[str, str]:
    """Every number on the lines as printed, by label ``"<line> <template> #<k>"``."""
    out = {}
    for i, line in enumerate(text_lines):
        t = template(line)
        for k, tok in enumerate(NUMBER.findall(line)):
            out[f"{i:02d} {t} #{k}"] = tok
    return out


def parse(text_lines: Sequence[str]) -> Dict[str, float]:
    """Every number on the lines, by the labels of :func:`tokens`."""
    return {label: _value(tok) for label, tok in tokens(text_lines).items()}


def labelled(lines: Lines) -> Dict[str, float]:
    """The numbers of :func:`printed`, unrounded, by :func:`parse`'s labels."""
    full = _Full()
    text = []
    for fmt, args in lines:
        text.extend(full.format(fmt, *(_scalar(a) for a in args)).split("\n"))
    return parse(text)


def tolerance(label: str, table, integer: bool):
    """The class of a label: the first ``(pattern, kind, value)`` of an
    example's ``TOLERANCE`` whose pattern the label matches (``re.search``),
    else exact for integers (counts, ranks, flags), 0.05 dB on a line that
    prints dB, rtol 1e-3 otherwise."""
    for pattern, kind, value in table:
        if re.search(pattern, label):
            return kind, value
    if integer:
        return "exact", 0.0
    return ("db", 0.05) if " dB" in label else ("rel", 1e-3)


def mismatches(got: Dict[str, float], want: Dict[str, float], table=(), slack=None) -> List[str]:
    """The labels at which ``got`` misses ``want`` under its class, each with
    the reason; [] where all agree.  Kinds: 'exact'; 'rel' r (|Δ| ≤ r·|want|);
    'db' or 'abs' a (|Δ| ≤ a); 'mc' se (|Δ| ≤ 4·se, se a Monte-Carlo
    estimate's standard error).  ``slack(label)`` widens every bound but
    'exact' (half the last digit of a printed reference)."""
    if set(got) != set(want):
        return [f"labels differ: only got {sorted(set(got) - set(want))}, only want {sorted(set(want) - set(got))}"]
    bad = []
    for label, w in want.items():
        g = got[label]
        integer = all(math.isfinite(v) and float(v).is_integer() for v in (g, w))
        kind, value = tolerance(label, table, integer)
        if kind == "exact":
            ok = g == w
        else:
            bound = {"rel": value * abs(w), "db": value, "abs": value, "mc": 4 * value}[kind]
            ok = abs(g - w) <= bound + (slack(label) if slack else 0.0)
        if not ok:
            bad.append(f"{label}: {g!r} against {w!r} ({kind} {value})")
    return bad


def moved(problem: dict, device) -> dict:
    """The problem's tensors on ``device``; generators and numbers as they are."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in problem.items()}


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal float32 draws on ``gen``'s device."""
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def nmse(xhat: torch.Tensor, x: torch.Tensor) -> float:
    """Σ|x̂ − x|² / Σ|x|² in float64."""
    xhat, x = xhat.detach().cpu().to(torch.complex128), x.detach().cpu().to(torch.complex128)
    return float((xhat - x).abs().square().sum() / x.abs().square().sum())


def nmse_db(xhat: torch.Tensor, x: torch.Tensor) -> float:
    return 10 * float(np.log10(nmse(xhat, x)))
