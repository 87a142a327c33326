"""train_img_per_s: images stepped (global batch x steps) over the whole
window, from the first step's feed to the device's end of the last step."""


def read(rec):
    return rec["images"] / rec["window_s"]
