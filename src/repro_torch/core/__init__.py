"""Backend-free numerics of the pipeline: similarity, Laplacian scaling,
Lanczos, k-means++ seeding and Lloyd k-means."""
