"""The harness's span around ``ArchesSession.host_policies``: both experts
profiled on the policy's training scenario and the tree fitted."""


def read(run):
    return run.spans.get("policy_fit")
