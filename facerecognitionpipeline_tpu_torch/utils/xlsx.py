"""Zero-dependency .xlsx workbook writer.

The port's own copy of `facerecognitionpipeline_tpu/utils/xlsx.py` (the
port imports nothing of the JAX package): the evaluation exports one sheet
per summary table (reference `temp.py:502-808`, `export_results_to_excel`)
without openpyxl, writing the OOXML spreadsheet parts directly with the
stdlib (`zipfile` + manual XML).

Scope: multiple sheets, header row styling (bold), numbers stored as
numbers, everything else as inline strings; no formulas, merged cells or
charts. `zipfile` stamps each member with the current time, so two writes
of one table differ in bytes but not in member XML; `read_xlsx_rows` parses
a workbook written here back into rows.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, Iterable, List, Sequence, Union
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
{sheet_overrides}</Types>
"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>
"""

# cellStyleXfs/cellXfs index 1 = bold (header row)
_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="2"><font><sz val="11"/><name val="Calibri"/></font>
<font><b/><sz val="11"/><name val="Calibri"/></font></fonts>
<fills count="1"><fill><patternFill patternType="none"/></fill></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="2"><xf xfId="0"/><xf xfId="0" fontId="1" applyFont="1"/></cellXfs>
</styleSheet>
"""


def _col_letter(idx: int) -> str:
    """0 -> A, 25 -> Z, 26 -> AA ..."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


_INVALID_SHEET_CHARS = re.compile(r"[\\/?*\[\]:]")


def _sheet_name(name: str, used: set) -> str:
    clean = _INVALID_SHEET_CHARS.sub("_", str(name))[:31] or "Sheet"
    base, n = clean, 1
    while clean.lower() in used:
        n += 1
        suffix = f"_{n}"
        clean = base[: 31 - len(suffix)] + suffix
    used.add(clean.lower())
    return clean


def _cell_xml(ref: str, value, style: int = 0) -> str:
    s = f' s="{style}"' if style else ""
    if value is None:
        return ""
    if isinstance(value, bool):  # before int: bool is an int subclass
        return f'<c r="{ref}"{s} t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if isinstance(value, float) and (value != value or value in
                                         (float("inf"), float("-inf"))):
            value = str(value)  # NaN/inf: not representable as xlsx numbers
        else:
            return f'<c r="{ref}"{s}><v>{value!r}</v></c>'
    text = escape(str(value))
    return (f'<c r="{ref}"{s} t="inlineStr"><is><t xml:space="preserve">'
            f"{text}</t></is></c>")


def _sheet_xml(rows: Iterable[Sequence], header_bold: bool) -> str:
    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>',
    ]
    for r, row in enumerate(rows):
        style = 1 if (header_bold and r == 0) else 0
        cells = "".join(
            _cell_xml(f"{_col_letter(c)}{r + 1}", v, style)
            for c, v in enumerate(row)
        )
        parts.append(f'<row r="{r + 1}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


TableLike = Union[Sequence[Sequence], "pandas.DataFrame"]  # noqa: F821


def _as_rows(table: TableLike) -> List[Sequence]:
    """DataFrame -> [header, *rows]; row-lists pass through."""
    if hasattr(table, "itertuples") and hasattr(table, "columns"):
        rows: List[Sequence] = [list(table.columns)]
        for tup in table.itertuples(index=False, name=None):
            rows.append(
                [v.item() if hasattr(v, "item") else v for v in tup]
            )
        return rows
    return list(table)


def write_xlsx(
    path: str,
    sheets: Dict[str, TableLike],
    header_bold: bool = True,
) -> None:
    """Write `sheets` (name -> DataFrame or rows-of-cells) as a workbook.

    Sheet order follows dict order; names are sanitized/deduplicated to
    Excel's 31-char rules. Numbers (incl. numpy scalars via .item()) store
    as xlsx numbers; booleans as booleans; everything else as text.
    """
    if not sheets:
        raise ValueError("write_xlsx needs at least one sheet")
    used: set = set()
    named = [(_sheet_name(n, used), _as_rows(t)) for n, t in sheets.items()]

    sheet_overrides = "".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
        f'ContentType="application/vnd.openxmlformats-officedocument.'
        f'spreadsheetml.worksheet+xml"/>'
        for i in range(len(named))
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.'
        'org/officeDocument/2006/relationships"><sheets>'
        + "".join(
            f'<sheet name="{escape(name)}" sheetId="{i + 1}" '
            f'r:id="rId{i + 1}"/>'
            for i, (name, _) in enumerate(named)
        )
        + "</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package'
        '/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
            f'openxmlformats.org/officeDocument/2006/relationships/'
            f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(len(named))
        )
        + f'<Relationship Id="rId{len(named) + 1}" Type="http://schemas.'
        f'openxmlformats.org/officeDocument/2006/relationships/styles" '
        f'Target="styles.xml"/>'
        + "</Relationships>"
    )

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(
            "[Content_Types].xml",
            _CONTENT_TYPES.format(sheet_overrides=sheet_overrides),
        )
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/styles.xml", _STYLES)
        for i, (_, rows) in enumerate(named):
            z.writestr(
                f"xl/worksheets/sheet{i + 1}.xml",
                _sheet_xml(rows, header_bold),
            )


def read_xlsx_rows(path: str) -> Dict[str, List[List]]:
    """Parse a workbook written by write_xlsx back into rows per sheet.

    A test/verification helper (no openpyxl in this image), NOT a general
    xlsx reader: it understands inline strings, numbers, and booleans —
    exactly what write_xlsx emits.
    """
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
    out: Dict[str, List[List]] = {}
    with zipfile.ZipFile(path) as z:
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        names = [s.get("name") for s in wb.findall(".//m:sheet", ns)]
        for i, name in enumerate(names):
            sheet = ET.fromstring(z.read(f"xl/worksheets/sheet{i + 1}.xml"))
            rows = []
            for row in sheet.findall(".//m:row", ns):
                vals = []
                for c in row.findall("m:c", ns):
                    t = c.get("t")
                    if t == "inlineStr":
                        el = c.find("m:is/m:t", ns)
                        vals.append(el.text or "" if el is not None else "")
                    else:
                        v = c.find("m:v", ns)
                        raw = v.text if v is not None else None
                        if raw is None:
                            vals.append(None)
                        elif t == "b":
                            vals.append(bool(int(raw)))
                        else:
                            num = float(raw)
                            vals.append(int(num) if num.is_integer() and
                                        "." not in raw and "e" not in
                                        raw.lower() else num)
                rows.append(vals)
            out[name] = rows
    return out
