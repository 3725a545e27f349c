"""The benchmark's harness: manifest, seeded inputs, the traffic loop,
the trace reader, the cost arithmetic and the correctness comparison."""
