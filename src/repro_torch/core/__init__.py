"""The paper's primary contribution: joint batchsize selection and
communication resource allocation (Algorithm 1) and the FEEL horizon
planner that applies it."""
