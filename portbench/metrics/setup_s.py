"""setup_s: process start to the first timed unit of work, in s."""


def read(rec):
    return rec["setup_s"]
