"""Plain float32 reference models of the benchmark's configurations, one
module a family, named by a configuration's ``reference`` key. They import
nothing of the program."""
