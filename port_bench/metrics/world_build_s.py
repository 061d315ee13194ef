"""The world build's phases, summed (``build_world(phase_times=)``, CUDA
events on the card)."""


def read(rec):
    if not rec.phase_times:
        return None
    return sum(rec.phase_times.values())
