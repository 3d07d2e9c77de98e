"""setup_s: seconds from the process's start to the first timed pass
(imports, inputs from the seed, the route's set-up and warm pass)."""


def read(records):
    return records["setup_s"]
