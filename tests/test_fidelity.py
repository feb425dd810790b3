"""The trail-segment fidelity certificate (utils/fidelity.py).

``trail_segments`` changes geometry, so a segment count may only render
production frames under a committed winner-flip bound
(benchmarks/results/fidelity_trail_segments.json, written by
benchmarks/fidelity_trail.py).
"""

import json
import os

from pointcloud_render.utils.fidelity import (
    GEOMETRY_REL_MARGIN,
    trail_segments_flip_rate,
)

CERT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                    "results", "fidelity_trail_segments.json")


def _cert():
    with open(CERT) as f:
        return json.load(f)


def test_flip_rate_within_recorded_bound():
    """Recompute the winner-flip rate of segments=4 at CI scale and pin
    it against the committed certificate's bound — a geometry regression
    (or a bound edit that outruns the measurement) fails here."""
    cert = _cert()
    r = trail_segments_flip_rate(4, n_points=1500, frames=(120,))
    assert r["trail_rate"] <= cert["bound"]
    assert r["kind_rate"] <= r["trail_rate"]


def test_certificate_within_its_limit():
    """Every certified (preset, segments) record is within the limit:
    the absolute bound, or the default-8 rate plus the margin where the
    default itself exceeds the bound."""
    cert = _cert()
    for preset, scene in cert["scenes"].items():
        rates = scene["rates"]
        anchor = rates["8"]["trail_rate"]
        limit = max(cert["bound"], anchor + GEOMETRY_REL_MARGIN)
        for segs, rec in rates.items():
            assert rec["trail_rate"] <= limit, (preset, segs)
            assert rec["kind_rate"] <= rec["trail_rate"], (preset, segs)
