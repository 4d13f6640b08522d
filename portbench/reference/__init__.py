"""Plain PyTorch / numpy reference of the benchmarked models and steps; imports
nothing of the program."""
