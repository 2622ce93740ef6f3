"""Mean time a step of the measured window waited inside the harness's
loader for its batch (the data's decode, crop and augmentations), ms."""


def read(rec):
    return rec.get("wait_ms")
