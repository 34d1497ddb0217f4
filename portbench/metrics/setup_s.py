"""setup_s: seconds from the harness's first line to the first timed call
(imports, kernel loads or builds, corpus on the card and its host copy,
stage(), compile(), the warm-up calls). Host clock."""


def read(run):
    return run["setup_s"]
