"""Point-cloud generators, one module each, named by a configuration's
``points.generator``; each exports ``points(n, ..., seed)``, float64
(V, 3) drawn on the host."""
