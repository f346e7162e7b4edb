"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
2 cameras at 256x192, 16 trackers of 16 features, 64 vertices, 20 BLS
iterations, 4 people on a 16-frame loop."""

import copy

import cells


def tiny_cell(config="bench4cam_k30", traffic="dense22",
              cell="bench4cam_k30.dense22"):
    """(configuration, mix, limits) of the tiny cell: the cell's own
    limits, with the chosen frames closer together and MOTA held to the
    tiny scene's own limit (`TINY_MISS_SHARE`)."""
    c = copy.deepcopy(cells.config(config))
    e = c["engine"]
    e.update(num_cameras=2, image_width=256, image_height=192)
    e["tracker2d"].update(max_detections=8, max_trackers=16, max_features=16)
    e["assoc3d"].update(k_best_size=4)
    e["solver"].update(max_vertices=64, max_iterations=20, num_replicas=4)
    t = copy.deepcopy(cells.traffic(traffic))
    t.update(period=16, people=4, arena_mm=6000.0, row_buckets=[64])
    lim = dict(cells.limits(cell), check_every=3, check_count=4,
               miss_share=TINY_MISS_SHARE)
    return c, t, lim


TINY_MISS_SHARE = 0.37
