"""Boxes the detecting route kept a frame over the traced window: the
difference of its `boxes_kept` counter over that of `frames_detected`."""


def read(rec, name):
    frames = rec["driver"].get("detect_frames", 0)
    if not frames:
        return None
    return rec["driver"].get("detect_boxes", 0) / frames
