"""Valid cubes the harness sent (the boxes of the frames scored in the
traced window) over the cube rows the completion ensemble's forwards
received (a forward pre-hook on the program's SelfCompletionNet)."""


def read(rec, name):
    rows = rec["driver"].get("rows_seen", 0)
    valid = rec["work"].get("valid_cubes", 0)
    if not rows or not valid:
        return None
    return 100.0 * valid / rows
