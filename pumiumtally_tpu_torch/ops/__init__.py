"""Device operations: the walks (kernels W0, W1), point location, partitions."""
