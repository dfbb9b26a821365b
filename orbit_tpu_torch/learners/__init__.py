"""Eval functions and the test-mode learner of the port."""
