"""The one traffic generator: a configuration's sweep under a mix's parameters.

A configuration file gives ``point`` (every field of the program's point
configuration, as the reference needs them too), ``sweep`` (zipped lists of
the fields and of ``snr_db`` that change from point to point) and, where the
sweep does not hold it, one ``snr_db``; the noise variance of a point is
10^(-snr_db/10) (``plot_errorVSsnr.m:49``).  A traffic file gives the
``methods``, the ``svt_method`` route, ``n_mc`` realizations a point, the
``order`` of the points and the ``loop``.

Points follow one another in the sweep's order, pass after pass.  Point k of
a run (k = 0, 1, ...) draws its realizations from (seed, k), so every pass
sees fresh channels; the work of a point depends on its shapes alone, so
every seed gives the same sequence of sizes.  The warm-up points draw from
sweep indices of their own, far past any window's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

WARMUP_BASE = 1 << 40  # sweep indices of the warm-up points
WARMUPS_PER_SHAPE = 2


@dataclasses.dataclass(frozen=True)
class Point:
    k: int  # the point's place in the run; its realizations come from (seed, k)
    position: int  # its place in the sweep
    fields: Tuple[Tuple[str, object], ...]  # the point configuration, (name, value) pairs: its shapes and work
    snr_db: float
    methods: Tuple[str, ...]
    svt_method: str
    n_mc: int

    @property
    def params(self) -> Dict[str, object]:
        return dict(self.fields)

    @property
    def noise_var(self) -> float:
        return float(10.0 ** (-self.snr_db / 10.0))


class Schedule:
    """The points of one cell, in the order the window runs them."""

    def __init__(self, config: dict, traffic: dict):
        if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
            raise ValueError("the generator runs a closed loop of one client")
        if traffic.get("order") != "sweep":
            raise ValueError(f"unknown order {traffic.get('order')!r}; the generator knows 'sweep'")
        sweep = config["sweep"]
        lengths = {len(v) for v in sweep.values()}
        if len(lengths) != 1:
            raise ValueError("the sweep's lists differ in length")
        self.size = lengths.pop()
        self.methods = tuple(traffic["methods"])
        self.svt_method = traffic["svt_method"]
        self.n_mc = int(traffic["n_mc"])
        self._sweep = []
        for i in range(self.size):
            fields = dict(config["point"])
            fields.update({key: values[i] for key, values in sweep.items() if key != "snr_db"})
            snr = sweep["snr_db"][i] if "snr_db" in sweep else config["snr_db"]
            self._sweep.append((tuple(sorted(fields.items())), float(snr)))

    def point(self, k: int, position: int) -> Point:
        fields, snr = self._sweep[position]
        return Point(k, position, fields, snr, self.methods, self.svt_method, self.n_mc)

    def window(self, start: int = 0) -> Iterator[Point]:
        """Points k = start, start + 1, ... without end, cycling through the sweep."""
        k = start
        while True:
            yield self.point(k, k % self.size)
            k += 1

    def warmups(self) -> List[Point]:
        """Each distinct shape of the sweep, ``WARMUPS_PER_SHAPE`` times."""
        seen, out = set(), []
        for position in range(self.size):
            if self._sweep[position][0] in seen:
                continue
            seen.add(self._sweep[position][0])
            for _ in range(WARMUPS_PER_SHAPE):
                out.append(self.point(WARMUP_BASE + len(out), position))
        return out
