"""Stereo ORB front end: camera model, ORB extraction, stereo matching."""
