"""ARCHES core of the port: expert bank, closed loop, policies, session."""
