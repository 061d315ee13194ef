"""The share of the window's frames that the program put at the quarter
tier, percent."""


def read(rec):
    if not rec.frames:
        return None
    return 100.0 * sum(r == "quarter" for r, _ in rec.frames) / len(
        rec.frames)
