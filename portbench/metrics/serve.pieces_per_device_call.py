"""serve.pieces_per_device_call: the pieces the service finished in the
window over the device calls it made for them (`GenerationService.
device_calls`), how far coalescing and time slicing share a call.  Moves
request_ms_p95."""


def read(run):
    f = run.facts
    if not f.get("device_calls"):
        return None
    return f["pieces"] / f["device_calls"]
