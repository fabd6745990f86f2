"""Mean per traced point of the front end's span (``proposed_problem``
between two synchronisations), in ms."""


def read(record):
    spans = [s.seconds for s in record.spans if s.name == "frontend"]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
