"""Points to the card, ``_device.points_to_device`` (pinned), ms (staged
query, median)."""


def read(rec):
    return rec.stage_ms("h2d")
