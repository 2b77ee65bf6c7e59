"""Tests of the benchmark itself (not collected by the suite under tests/)."""
