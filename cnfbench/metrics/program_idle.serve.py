"""The device's idle share of the traced window under the program's spans,
in %: 100 x ``program_idle_s`` over the window, where each moment of idle
goes to the innermost ``cnf.*`` span the host was in (``spans.py``). None
where the program made no span."""


def read(record):
    if record.get("kind") != "serve" or not record.get("program_spans"):
        return None
    return 100.0 * record["program_idle_s"] / record["window_s"]
