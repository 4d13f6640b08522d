"""Traffic generators: each module turns a traffic file's parameters and a
seed into the inputs of one run (``generate(params, seed)``)."""
