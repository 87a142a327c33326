"""serve_img_per_s: images whose proposals reached the host, over the
whole window (first call to the last copy back)."""


def read(rec):
    return rec["images"] / rec["window_s"]
