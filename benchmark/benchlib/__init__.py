"""The benchmark's library: its definition found by name (spec), the
scene generator, the work counts and peaks, the trace reduction, the
plain reference, the comparison that decides `correct`, and the
endpoints that drive the program."""
