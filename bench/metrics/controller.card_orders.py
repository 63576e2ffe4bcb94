"""controller.card_orders: the program's count ``plan_card_orders`` (the
plans whose psi order ran on the stage's card), per interval of the
window. Read from the reports' trace records. A program that orders psi
on the host alone (no ``CARD_ORDER_MIN_KEYS`` in its planner core) gives
nothing to read."""

from bench import program_trace


def read(run):
    from repro_torch.core.balancer import llfd
    if not hasattr(llfd, "CARD_ORDER_MIN_KEYS"):
        return None
    return program_trace.count(run, "plan_card_orders")
