"""``cycle_roofline``'s least bytes against counts by hand."""

from benchmark.harness import load_metric

roof = load_metric("cycle_roofline")


def test_level_shapes_follow_cedar():
    assert roof.level_shapes((9, 9), 3) == [(9, 9), (5, 5), (3, 3)]
    assert roof.level_shapes((8192, 8192), 3)[-1] == (4, 4)
    assert len(roof.level_shapes((8192, 8192), 3)) == 12
    assert roof.level_shapes((9, 9), 3, num_levels=2) == [(9, 9), (5, 5)]
    assert roof.level_shapes((5, 5, 5), 3) == [(5, 5, 5), (3, 3, 3)]


def test_three_level_2d_hierarchy_by_hand():
    """9², 5², 3², 5-point, point relaxation, float64."""
    config = {"grid": [9, 9], "stencil": "five_pt", "dtype": "float64",
              "solver": {"solver": {"relaxation": "point",
                                    "min-coarse": 3}}}
    level0 = (3 * 81      # O, W, S
              + 81        # 1/diag
              + 81 + 2 * 81   # b read, x read and written
              + 25        # restricted rhs written
              + 8 * 25)   # interpolation weights to 5²
    level1 = 5 * 25 + 25 + 3 * 25 + 9 + 8 * 9   # nine-point
    level2 = 9 * 9 + 2 * 9   # dense inverse, b read, x written
    assert roof.cycle_bytes(config) == 8 * (level0 + level1 + level2)


def test_two_level_plane_hierarchy_by_hand():
    """5³ then 3³, 7-point, plane-xy; each of the five 5² planes has the
    embedded 5², 3² hierarchy, line-xy, float32."""
    config = {"grid": [5, 5, 5], "stencil": "seven_pt", "dtype": "float32",
              "solver": {"solver": {"relaxation": "plane-xy",
                                    "min-coarse": 3},
                         "plane-config": {"solver": {
                             "relaxation": "line-xy", "min-coarse": 3}}}}
    level0 = 4 * 125 + 3 * 125 + 27 + 26 * 27   # no 1/diag
    level1 = 27 * 27 + 2 * 27
    # a plane's 5² level is the 3D level's own; its 3² level is coarsest
    plane = (9 + 8 * 9) + (9 * 9 + 2 * 9)
    assert roof.cycle_bytes(config) == 4 * (level0 + level1 + 5 * plane)


def test_cells_least_bytes():
    import json

    from benchmark import harness

    cfg = json.loads((harness.BENCH / "configs" /
                      "poisson2d-5pt-8192-f64.json").read_text())
    # level 0 alone: 7 arrays of 8192² float64 (537 MB each)
    assert 7 * 8 * 8192**2 < roof.cycle_bytes(cfg) < 14 * 8 * 8192**2
