"""HTTP serving of the port: the coalescing batcher and the server."""
