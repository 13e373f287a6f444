"""The benchmark's own code: manifest, inputs, profiling, report."""
