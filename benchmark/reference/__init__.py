"""The plain reference the benchmark judges the port by.

Plain NumPy and PyTorch, with SciPy's k-d tree for the neighbours:
it imports nothing of the port (``gravomg_tpu_torch``), nor the JAX
package or JAX, and takes nothing the port made.  From the same float32
points the benchmark hands the port, it works out again the kNN graph,
the inverse-distance Laplacian and lumped mass, the screened-Poisson
operator, and solves in float64 (any other dtype for a control).
"""
