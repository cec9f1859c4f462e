"""Phase 19's SplatFields3D check in ``chip_smoke.py`` on the CPU (no
JAX): ``neighbour_flips`` passes a neighbourhood that two KNN runs split
differently at a near tie and fails one swapped for a point that is no
tie; ``phase19_failures`` passes readings like an H100's (field gap
7.712e-7, Moran's I on equal inputs 5.975e-8) and fails a 1e-4 field
gap, a bf16 field's 5.062e-3, a Moran gap past 1e-5 and a non-tie flip;
the CPU's recomputed neighbourhood weights catch a fault in the card's.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch.ops import knn


@pytest.fixture(scope="module")
def cloud():
    """Two KNN runs on positions 4e-6 apart, with a built-in near tie:
    point 1 sits 2e-6 beyond point 0's 4th-nearest neighbour in the first
    and 2e-6 short of it in the second (well past the f32 formula's
    rounding), so the two runs swap them in point 0's neighbourhood."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (200, 3))
    d = np.linalg.norm(pts - pts[0], axis=1)
    order = np.argsort(d)
    fourth = order[4]                       # order[0] is point 0 itself
    direction = rng.randn(3)
    direction /= np.linalg.norm(direction)
    pts[1] = pts[0] + direction * (d[fourth] + 2e-6)
    moved = pts.copy()
    moved[1] = pts[0] + direction * (d[fourth] - 2e-6)
    a = torch.tensor(pts, dtype=torch.float32)
    b = torch.tensor(moved, dtype=torch.float32)
    _, nn_a = knn.query_nn(a, n_neighbors=5)
    _, nn_b = knn.query_nn(b, n_neighbors=5)
    return a, nn_a, b, nn_b


def test_a_near_tie_flip_passes(cloud):
    a, nn_a, b, nn_b = cloud
    flips = chip_smoke.neighbour_flips(a, nn_a, b, nn_b)
    assert flips["rows"] >= 1 and 0 in set(
        np.flatnonzero((np.sort(nn_a.numpy(), 1)
                        != np.sort(nn_b.numpy(), 1)).any(1)))
    assert flips["non_ties"] == [] and flips["worst"] <= 1.0
    assert 0 < flips["position_gap"] < 1e-5
    # equal runs: no row differs
    same = chip_smoke.neighbour_flips(a, nn_a, a, nn_a)
    assert same == dict(rows=0, non_ties=[], worst=0.0, position_gap=0.0)


def test_a_flip_that_is_no_tie_fails(cloud):
    a, nn_a, b, nn_b = cloud
    row = 17
    far = int(((a.double() - a[row].double()) ** 2).sum(1).argmax())
    swapped = nn_a.clone()
    swapped[row, -1] = far
    flips = chip_smoke.neighbour_flips(a, swapped, b, nn_b)
    assert row in flips["non_ties"] and flips["worst"] > 1e3


def test_phase19_failures(cloud):
    a, nn_a, b, nn_b = cloud
    flips = chip_smoke.neighbour_flips(a, nn_a, b, nn_b)
    report = {"moran_scale": 0.31, "moran_rotation": 0.52,
              "moran_opacity": 0.12, "moran_rgb": 0.77}
    near = {k: v + 5.975e-8 for k, v in report.items()}
    field = {"scale": 3.1e-7, "rotation": 7.712e-7, "means": 1.2e-7}
    assert chip_smoke.phase19_failures(field, report, near, flips) == []
    for gap in (1e-4, 5.062e-3):   # a 1e-4 gap; the bf16 MLP's
        out = chip_smoke.phase19_failures(dict(field, rotation=gap), report,
                                          near, flips)
        assert len(out) == 1 and "field outputs" in out[0]
    off = dict(near, moran_scale=report["moran_scale"] + 2e-5 * 0.41)
    out = chip_smoke.phase19_failures(field, report, off, flips)
    assert len(out) == 1 and "Moran's I" in out[0]
    swapped = nn_a.clone()
    swapped[17, -1] = int(((a.double() - a[17].double()) ** 2).sum(1)
                          .argmax())
    out = chip_smoke.phase19_failures(
        field, report, near, chip_smoke.neighbour_flips(a, swapped, b, nn_b))
    assert len(out) == 1 and "not near ties" in out[0]


def test_weights_recomputed_on_the_cpu_catch_a_weight_fault(cloud):
    """Phase 19 recomputes the neighbourhood weights on the CPU from the
    card's positions and neighbourhoods: ``neighbourhood_weights`` is
    ``query_nn``'s formula, and weights from the wrong distances (one
    axis dropped) move Moran's I past TOL_MORAN."""
    from splatfields_torch import extract_geo
    a, nn_a, _, _ = cloud
    w, idx = knn.query_nn(a, n_neighbors=5)
    assert torch.equal(knn.neighbourhood_weights(a, idx), w)
    attrs = {"opacity": torch.sin(3 * a[:, :1]) + 0.1 * a[:, 1:2],
             "scale": torch.cos(2 * a) * a[:, 2:]}
    report = extract_geo.morans_of(attrs, w, idx)
    cpu = extract_geo.morans_of(attrs, knn.neighbourhood_weights(a, idx), idx)
    field = {"opacity": 3.1e-7, "means": 1.2e-7}
    flips = chip_smoke.neighbour_flips(a, idx, a, idx)
    assert chip_smoke.phase19_failures(field, report, cpu, flips) == []
    bad = extract_geo.morans_of(attrs, knn.neighbourhood_weights(
        a * torch.tensor([1.0, 1.0, 0.0]), idx), idx)
    out = chip_smoke.phase19_failures(field, bad, cpu, flips)
    assert len(out) == 1 and "Moran's I" in out[0]
