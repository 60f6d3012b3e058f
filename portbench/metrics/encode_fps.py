"""encode_fps: every frame whose packets were muxed in the window, over
the window's seconds (first launch to last packet muxed)."""


def read(rec):
    if rec["window_s"] <= 0 or not rec["frames"]:
        return None
    return rec["frames"] / rec["window_s"]
