"""Minimal XLSX writer (no openpyxl in the image), a copy of
``brats21_tpu/utils/xlsx.py``.

XLSX is a zip of XML parts; this emits just enough — workbook, one or more
inline-string/number worksheets, content types, rels — for the
``Evaluation.xlsx`` per-patient report the reference produces with pandas
(visualization.py:120-137, files.py:269-333) to open in Excel/LibreOffice.
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheets}
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>{sheets}</sheets>
</workbook>"""

_WB_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}
</Relationships>"""


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def _cell(row: int, col: int, value: Any) -> str:
    ref = f"{_col_name(col)}{row}"
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return f'<c r="{ref}"><v>{value}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def _sheet_xml(rows: Sequence[Sequence[Any]]) -> str:
    body = []
    for ri, row in enumerate(rows, start=1):
        cells = "".join(_cell(ri, ci, v) for ci, v in enumerate(row)
                        if v is not None)
        body.append(f'<row r="{ri}">{cells}</row>')
    return ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main"><sheetData>'
            + "".join(body) + "</sheetData></worksheet>")


def write_xlsx(path: str, sheets: Dict[str, Sequence[Sequence[Any]]]) -> None:
    """sheets: {sheet_name: rows}; each row a list of str/float cells."""
    names = list(sheets)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        overrides = "\n".join(
            f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
            f'ContentType="application/vnd.openxmlformats-officedocument.'
            f'spreadsheetml.worksheet+xml"/>' for i in range(len(names)))
        z.writestr("[Content_Types].xml", _CONTENT_TYPES.format(sheets=overrides))
        z.writestr("_rels/.rels", _ROOT_RELS)
        sheet_tags = "".join(
            f'<sheet name="{escape(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
            for i, n in enumerate(names))
        z.writestr("xl/workbook.xml", _WORKBOOK.format(sheets=sheet_tags))
        rels = "\n".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.openxmlformats'
            f'.org/officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i + 1}.xml"/>' for i in range(len(names)))
        z.writestr("xl/_rels/workbook.xml.rels", _WB_RELS.format(rels=rels))
        for i, name in enumerate(names):
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                       _sheet_xml(sheets[name]))
