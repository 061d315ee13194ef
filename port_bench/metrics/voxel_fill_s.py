"""The world build's fine voxel fill (``voxel_grid.generate``), its phase
of ``build_world(phase_times=)``."""


def read(rec):
    return rec.phase_times.get("building fine voxel grid")
