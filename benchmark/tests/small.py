"""A cell shrunk to the CPU for the harness's tests: the 64x64x8 grid
(0.5 m voxels over +-16 m, so the peak filter runs), widths 8..128, two
scenes a batch, three pool batches, 2048 points an agent, 16 candidates
an agent."""


def shrink(cell) -> None:
    g = cell.config["grid"]
    g["voxel_size"] = [0.5, 0.5, 0.625]
    g["area_extents"] = [[-16.0, 16.0], [-16.0, 16.0], [-3.0, 2.0]]
    g["shape"] = [64, 64, 8]
    cell.config["stage_channels"] = [8, 16, 32, 64, 128]
    t = cell.traffic
    t["batch"], t["pool_batches"] = 2, 3
    t["scene"]["points_per_agent"] = 2048
    if "max_boxes" in t:
        t["max_boxes"] = 16


SEED = 2 ** 31 + 11
