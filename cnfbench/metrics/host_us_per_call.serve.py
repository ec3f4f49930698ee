"""The host's time in the serving call, in microseconds a call: the mean
span of ``cnf.serve.call`` (``serve/export.py``'s ``ServingArtifact.call``)
over the traced window's calls (``spans.py``). None where the program made
no such span."""


def read(record):
    call = (record.get("program_spans") or {}).get("cnf.serve.call")
    if record.get("kind") != "serve" or not call:
        return None
    return 1e6 * call["host_s"] / call["count"]
