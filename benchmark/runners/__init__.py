"""Runners, one a kind of traffic: a traffic file names its runner."""
