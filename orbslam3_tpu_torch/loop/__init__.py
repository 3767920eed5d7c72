"""Loop closing: Sim3 estimation and the bag-of-words vocabulary."""
