"""The Semaphore application: the access set and its signals."""
