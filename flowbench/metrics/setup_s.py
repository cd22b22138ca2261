"""setup_s: seconds from the process's start to the first timed call
(weights, inputs, model, warm-up; on several cards from the launcher's start)."""


def read(rec):
    return rec.setup_s
