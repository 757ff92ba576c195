"""Host synchronisations a call makes: runtime calls inside an entry
span (``gmg:mg_solve``, ``gmg:heat_geodesics``) that block the host on
the device (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``) in the traced
stretch, over the entry spans in it (``benchmark/spans.py``; the
``# spans`` lines on stderr name the span each sync was made in).
Nothing off the card, or where the program opens no spans."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.calls or not sp.on_device:
        return None
    return sp.syncs / sp.calls
