"""Host synchronisations a solver iteration inside ``register``: the
runtime calls that block the host until the device is done
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, a blocking ``cudaMemcpy``) inside the
benchmark's ``register`` spans, over the iterations that the traced
requests' ``RegistrationResult.traces`` report. A read of a device value
(``.cpu()``, ``.item()``) is one ``cudaMemcpyAsync`` and one
``cudaStreamSynchronize``: it counts once."""

from torch_bench import trace


def read(p: trace.Profile):
    its = trace.iterations(p)
    if not its:
        return None
    index = trace.SpanIndex(p.spans)
    n = sum(1 for name, s, _ in p.runtime
            if name in trace.SYNC_CALLS and index.at(s) == "register")
    return n / its
